"""The layers under the port's fused rounds against the JAX reference, on
the CPU: the packet headers stamped from a round index held in a device
tensor, the bit channel fed its seed words as a tensor, the float32
stats, problem and solve of the in-round allocation (the reference's
``alloc_f32``).  Tolerances are stated per test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import seeds, words_np
from repro.configs.base import FLConfig as RefFLConfig
from repro.core import allocation as RA
from repro.core import quantize as RQ
from repro.wire import corrupt as WC
from repro.wire import format as fmt
from repro.wire import packets as PK
from repro_torch.configs.base import FLConfig
from repro_torch.core import allocation_jax as AJ
from repro_torch.core import bitchannel
from repro_torch.kernels import ops as tops
from repro_torch.training import fl_loop
from repro_torch.wire import corrupt as TC
from repro_torch.wire import packets as TPK

F32_ULP = np.finfo(np.float32).eps


def _uplink(k, n, bits, seed):
    rng = np.random.RandomState(seed)
    sign = rng.choice(np.array([-1, 1], np.int8), (k, n))
    qidx = rng.randint(0, 2 ** bits, (k, n)).astype(np.uint32)
    gmin = rng.uniform(0, 1e-3, k).astype(np.float32)
    gmax = gmin + rng.uniform(1e-3, 1e-2, k).astype(np.float32)
    return sign, qidx, gmin, gmax


@pytest.mark.parametrize('n_round', [0, 1, 2 ** 24 + 3])
def test_headers_from_a_device_round_index_match_reference(n_round):
    """The sign and modulus frames stamped from an int64 round-index
    tensor (a fused round's slot) and the resend's restamp equal the
    reference's for the same int n, bit for bit (the round field keeps n
    mod 2^24, ``ROUND_MASK``)."""
    k, n, bits = 3, 100, 3
    sign, qidx, gmin, gmax = _uplink(k, n, bits, n_round % 97)
    ref_s, ref_m = PK.encode_uplink_batch(
        jnp.asarray(sign), jnp.asarray(qidx), jnp.asarray(gmin),
        jnp.asarray(gmax), bits=bits, round_idx=jnp.uint32(n_round))
    idx = torch.tensor(n_round, dtype=torch.int64)
    got_s, got_m = TPK.encode_uplink_batch(
        torch.as_tensor(sign), torch.as_tensor(qidx.astype(np.int64)),
        torch.as_tensor(gmin), torch.as_tensor(gmax), bits=bits,
        round_idx=idx)
    np.testing.assert_array_equal(words_np(got_s), np.asarray(ref_s))
    np.testing.assert_array_equal(words_np(got_m), np.asarray(ref_m))
    # the same frames as from the Python int
    int_s, _ = TPK.encode_uplink_batch(
        torch.as_tensor(sign), torch.as_tensor(qidx.astype(np.int64)),
        torch.as_tensor(gmin), torch.as_tensor(gmax), bits=bits,
        round_idx=n_round)
    assert torch.equal(int_s, got_s)
    np.testing.assert_array_equal(
        words_np(TPK.restamp_sign_retx(got_s, 1)),
        np.asarray(PK.restamp_sign_retx(ref_s, 1)))
    assert (words_np(got_s)[:, 2] & fmt.ROUND_MASK == n_round
            & fmt.ROUND_MASK).all()


def _reference_corrupt(pair, words, ber):
    """The reference's bit channel at explicit seed words: its
    ``hash_bits`` and ``flip_threshold`` plane by plane."""
    thresh, allf = WC.flip_threshold(jnp.asarray(ber))
    idx = jnp.arange(words.size, dtype=jnp.uint32).reshape(words.shape)
    mask = jnp.zeros(words.shape, jnp.uint32)
    for j in range(32):
        h = WC.hash_bits(idx, j, np.uint32(pair[0]), np.uint32(pair[1]))
        bit = (h < thresh[:, None]) | allf[:, None]
        mask = mask | (bit.astype(jnp.uint32) << j)
    mask = np.asarray(mask)
    return (words ^ mask, np.bitwise_xor.reduce(mask, axis=1),
            np.array([sum(bin(int(w)).count('1') for w in row)
                      for row in mask]))


@pytest.mark.parametrize('pair', [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF),
                                  (0x0BADF00D, 0x5EED1234), 'key'])
def test_corrupt_fold_reads_its_seed_words_from_a_tensor(pair):
    """``corrupt_fold_words`` fed the seed pair as a (2,) int32 tensor
    (as a fused round's slot holds it) equals the reference's bit channel
    fed the same two words as ints, bit for bit, at the edge words 0 and
    0xFFFFFFFF and at random ones; the transport's (2 + n_retx, 2) rows
    are the same pairs."""
    if pair == 'key':
        pair = seeds(jax.random.PRNGKey(7))
    rng = np.random.RandomState(3)
    words = rng.randint(0, 2 ** 32, (4, 70), dtype=np.uint64).astype(
        np.uint32)
    ber = np.array([0.0, 0.01, 0.2, 1.0], np.float32)
    want = _reference_corrupt(pair, words, ber)
    st = tops.seed_words(pair, 'cpu')
    assert st.dtype == torch.int32 and tuple(st.shape) == (2,)
    rows = tops.seed_words([pair, (1, 2)], 'cpu')
    for s in (st, rows[0]):
        rx, fold, flips = tops.corrupt_fold_words(
            s, torch.as_tensor(words.view(np.int32)), torch.as_tensor(ber))
        np.testing.assert_array_equal(words_np(rx), want[0])
        np.testing.assert_array_equal(words_np(fold), want[1])
        np.testing.assert_array_equal(flips.numpy(), want[2])
    # the int pair takes the same path through a copy
    rx_int, _, _ = tops.corrupt_fold_words(
        pair, torch.as_tensor(words.view(np.int32)), torch.as_tensor(ber))
    np.testing.assert_array_equal(words_np(rx_int), want[0])
    assert TC.seed_pair(st)[0].item() == pair[0] & 0xFFFFFFFF


def test_transmit_uplink_takes_one_seed_tensor():
    """The uplink's seed rows: row 0 the modulus stream, row 1 + a sign
    attempt a; a wrong count of rows raises."""
    k, n, bits = 3, 64, 3
    sign, qidx, gmin, gmax = _uplink(k, n, bits, 1)
    sw, mw = TPK.encode_uplink_batch(
        torch.as_tensor(sign), torch.as_tensor(qidx.astype(np.int64)),
        torch.as_tensor(gmin), torch.as_tensor(gmax), bits=bits)
    q = torch.tensor([0.2, 0.6, 1.0])
    pairs = [(5, 6), (7, 8), (9, 10)]
    rep = bitchannel.transmit_uplink(sw, mw, q, q, n=n, bits=bits,
                                     seeds=tops.seed_words(pairs, 'cpu'),
                                     n_retx=1)
    ber_s = bitchannel.ber_for_success(q, sw.shape[1])
    rx, _, _ = tops.corrupt_fold_words(pairs[1], sw, ber_s)
    first = rep.sign_crc_ok
    np.testing.assert_array_equal(
        words_np(rep.sign_words)[first.numpy()],
        words_np(rx)[first.numpy()])
    with pytest.raises(ValueError, match='seed pairs'):
        bitchannel.transmit_uplink(sw, mw, q, q, n=n, bits=bits,
                                   seeds=tops.seed_words(pairs, 'cpu'))


def _stats_inputs(k=4, n=1500, per_client=False, seed=0):
    rng = np.random.RandomState(seed)
    g = (rng.standard_normal((k, n)) * rng.uniform(1e-3, 1e-1, (k, 1))
         ).astype(np.float32)
    gb = np.abs(rng.standard_normal((k, n) if per_client else (n,))
                * 1e-2).astype(np.float32)
    return g, gb


@pytest.mark.parametrize('per_client', [False, True])
def test_f32_stats_match_reference_sums(per_client):
    """g2, gb2 and v of a fused round equal ``jnp.sum`` in float32 over
    the same numpy-seeded gradients within 4 ulp (the two libraries sum
    in other orders); d2 equals the reference's per-client
    ``expected_quant_mse`` within the same 4 ulp."""
    g, gb = _stats_inputs(per_client=per_client)
    got = fl_loop.fused_stats(torch.as_tensor(g), torch.as_tensor(gb), 3)
    assert all(t.dtype == torch.float32 and t.shape == (4,) for t in got)
    gj, gbj = jnp.asarray(g), jnp.broadcast_to(jnp.asarray(gb), g.shape)
    want = (jnp.sum(gj ** 2, axis=1), jnp.sum(gbj ** 2, axis=1),
            jnp.sum(jnp.abs(gj) * gbj, axis=1),
            jax.vmap(lambda x: RQ.expected_quant_mse(x, 3))(gj))
    for name, a, b in zip(('g2', 'gb2', 'v', 'd2'), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=4 * F32_ULP, atol=0, err_msg=name)


def test_f32_problem_matches_reference():
    """The float32 problem of a fused round (``problem_from_stats`` with
    dtype float32) equals the reference's host problem from the same
    stats, gains and budgets within rtol 1e-6 (float32 rounding of its
    closed forms)."""
    fl = FLConfig(n_devices=4)
    g, gb = _stats_inputs()
    stats = [t.numpy() for t in fl_loop.fused_stats(
        torch.as_tensor(g), torch.as_tensor(gb), fl.quant_bits)]
    gains = np.array([1e-9, 3e-10, 2e-11, 5e-10], np.float32)
    p_w = np.full(4, fl.tx_power_w, np.float32)
    prob = AJ.problem_from_stats(
        *(torch.as_tensor(s) for s in stats), torch.as_tensor(gains),
        torch.as_tensor(p_w), g.shape[1], fl, dtype=torch.float32)
    assert prob.A.dtype == torch.float32
    ref = RA.problem_from_stats(*(s.astype(np.float64) for s in stats),
                                gains.astype(np.float64),
                                p_w.astype(np.float64), g.shape[1],
                                RefFLConfig(n_devices=4))
    for name in 'ABCD':
        np.testing.assert_allclose(getattr(prob, name).numpy(),
                                   getattr(ref.coef, name), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(prob.gains.numpy(), ref.gains, rtol=1e-6)
    assert float(prob.mod_bits) == ref.mod_bits


def test_f32_solve_within_its_contract():
    """The float32 solve of a fused round's problem (the plain version
    here; ``alloc_solve_f32`` on the card) stays within the f32 contract
    of ``tests/test_torch_allocation_jax_f32.py`` against the reference's
    float64 solve of the same stats: objective rtol 1e-4, q/p atol 5e-3."""
    fl = FLConfig(n_devices=4, tx_power_dbm=-14.0)
    g, gb = _stats_inputs(seed=2)
    stats = [t.numpy() for t in fl_loop.fused_stats(
        torch.as_tensor(g), torch.as_tensor(gb), fl.quant_bits)]
    gains = np.array([2e-9, 3e-10, 8e-11, 5e-10], np.float32)
    p_w = np.full(4, fl.tx_power_w, np.float32)
    prob = AJ.problem_from_stats(
        *(torch.as_tensor(s) for s in stats), torch.as_tensor(gains),
        torch.as_tensor(p_w), g.shape[1], fl, dtype=torch.float32)
    sol = tops.alloc_solve(prob, 'alternating', max_iters=2,
                           gate=torch.amax(prob.D))
    ref = RA.solve(RA.problem_from_stats(
        *(s.astype(np.float64) for s in stats), gains.astype(np.float64),
        p_w.astype(np.float64), g.shape[1], RefFLConfig(n_devices=4,
                                                        tx_power_dbm=-14.0)),
        'alternating', max_iters=2)
    assert sol.q.dtype == torch.float32
    assert float(sol.objective) == pytest.approx(ref.objective, rel=1e-4)
    np.testing.assert_allclose(sol.q.numpy(), ref.q, rtol=0, atol=5e-3)
    np.testing.assert_allclose(sol.p.numpy(), ref.p, rtol=0, atol=5e-3)
