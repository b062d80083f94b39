"""The plain versions of the port's four CUDA kernels (what the wrappers
in ``repro_torch.kernels.ops`` run on CPU tensors) against the Pallas
kernels in interpret mode, on the reference's grids.

Contract: integers (words, votes, folds, flip counts) bit-exact; the f32
decode-once sum within the reference's FMA-wobble bound ``ulp_atol``
(tests/test_packed_hotpath.py).  The CUDA kernels themselves are held to
the same plain versions on the card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import seeds, ulp_atol, words_np
from repro.kernels import ops
from repro.wire import format as fmt
from repro_torch.kernels import ops as tops
from repro_torch.wire.format import MASK32

GRID = [(k, n, bits) for k in (1, 2, 6) for n in (37, 65, 1000, 4097)
        for bits in (1, 3, 8)]
# The CUDA kernel's edges: one client and more than 32; n of one
# coordinate, around a group, around a warp's 4 groups (128) and a
# block's 16 groups (512); the narrowest, main and widest knob widths.
QUANTIZE_PACK_EDGES = [(1, 1, 1), (3, 31, 3), (2, 32, 8), (3, 33, 16),
                       (2, 127, 3), (2, 129, 1), (3, 511, 3), (2, 513, 16),
                       (33, 40, 3)]


def _grads(k, n, seed, bits):
    """Gaussian rows; g = 0, -0 and a tiny modulus first; row 1 of
    constant |g| (knob step 0); then |g| exactly on each row's knob
    boundaries gmin + j * step (the reference's f32 step), half of them
    negative."""
    rng = np.random.RandomState(seed)
    g = rng.randn(k, n).astype(np.float32) * 0.1
    g[:, :3] = [0.0, -0.0, 1e-30][:n]            # zero signs, tiny moduli
    if k > 1:
        g[1] = np.float32(-0.25)                 # constant |g|: step 0
    rand = rng.uniform(0, 1, (k, n)).astype(np.float32)
    a = np.abs(g)
    gmin, gmax = a.min(axis=1), a.max(axis=1)
    step = (gmax - gmin) / np.float32(2 ** bits - 1)
    m = max(0, min(n - 3, 2 ** bits))
    edge = gmin[:, None] + np.arange(m, dtype=np.float32) * step[:, None]
    edge[:, 1::2] *= -1
    g[:, 3:3 + m] = edge
    return g, rand, gmin, gmax


@pytest.mark.parametrize('k,n,bits', GRID + QUANTIZE_PACK_EDGES)
def test_quantize_pack_matches_pallas(k, n, bits):
    g, rand, gmin, gmax = _grads(k, n, seed=k * 7 + n + bits, bits=bits)
    sw, qw = tops.quantize_pack_flat(torch.as_tensor(g),
                                     torch.as_tensor(rand),
                                     torch.as_tensor(gmin),
                                     torch.as_tensor(gmax), bits)
    assert sw.shape == (k, fmt.n_groups(n))
    assert qw.shape == (k, fmt.n_groups(n) * bits)
    for i in range(k):
        rsw, rqw = ops.quantize_pack_flat(
            jnp.asarray(g[i]), jnp.asarray(rand[i]), gmin[i], gmax[i], bits,
            interpret=True)
        np.testing.assert_array_equal(words_np(sw[i]), np.asarray(rsw))
        np.testing.assert_array_equal(words_np(qw[i]), np.asarray(rqw))
    assert tops.launch_counts['quantize_pack'] == 0     # CPU: plain path


def _payloads(k, n, bits, seed):
    rng = np.random.RandomState(seed)
    sign = rng.choice([-1, 1], (k, n)).astype(np.int8)
    qidx = rng.randint(0, 2 ** bits, (k, n)).astype(np.int32)
    sw = np.array(fmt.pack_bits_ref(fmt.sign_to_bits(jnp.asarray(sign)), 1))
    qw = np.array(fmt.pack_bits_ref(jnp.asarray(qidx), bits))
    scal = dict(
        gmin=rng.uniform(0.0, 0.1, k).astype(np.float32),
        gmax=rng.uniform(0.5, 1.0, k).astype(np.float32),
        mod_ok=(rng.rand(k) < 0.7).astype(np.float32),
        weight=rng.uniform(0.0, 2.0, k).astype(np.float32),
        sign_ok=rng.rand(k) < 0.8)
    return sw, qw, scal


def _accumulate_both(k, n, bits, gbar, seed):
    sw, qw, s = _payloads(k, n, bits, seed)
    racc, rvotes = ops.spfl_aggregate_packed(
        jnp.asarray(sw), jnp.asarray(qw), jnp.asarray(gbar), s['gmin'],
        s['gmax'], s['mod_ok'], s['weight'], s['sign_ok'], n, bits,
        interpret=True, use_kernel=True)
    acc, votes = tops.spfl_aggregate_packed(
        torch.as_tensor(sw.view(np.int32)), torch.as_tensor(qw.view(np.int32)),
        torch.as_tensor(gbar), torch.as_tensor(s['gmin']),
        torch.as_tensor(s['gmax']), torch.as_tensor(s['mod_ok']),
        torch.as_tensor(s['weight']), torch.as_tensor(s['sign_ok']), n, bits)
    np.testing.assert_allclose(acc.numpy(), np.asarray(racc), rtol=0,
                               atol=ulp_atol(s['weight'], s['gmax'], gbar))
    return votes, rvotes


# The CUDA kernel's edges: one client, more clients than one 32-client
# shared-memory chunk (three chunks: no votes), n one off a 256-coordinate
# tile, 16 knob planes (the widest unrolled), 22-24 planes (the two
# shared-memory stages just under, at and past the 48 KB a block gets
# without opting in).
EDGES = [(1, 255, 3), (1, 257, 16), (3, 256, 16), (65, 300, 3),
         (40, 257, 16), (2, 257, 22), (3, 255, 23), (1, 300, 24)]


@pytest.mark.parametrize('k,n,bits', GRID + [(33, 200, 3)] + EDGES)
def test_spfl_accumulate_matches_pallas(k, n, bits):
    gbar = np.random.RandomState(n).uniform(0, 1, n).astype(np.float32)
    votes, rvotes = _accumulate_both(k, n, bits, gbar, seed=n + bits + k)
    if k > tops.MAX_VOTE_CLIENTS:
        assert votes is None and rvotes is None
    else:
        np.testing.assert_array_equal(votes.numpy(), np.asarray(rvotes))


@pytest.mark.parametrize('k,n,bits', [(1, 37, 3), (4, 777, 3), (6, 4097, 8),
                                     (1, 257, 16), (3, 255, 3)])
def test_spfl_accumulate_per_client_gbar_matches_pallas(k, n, bits):
    gbar = np.random.RandomState(k).uniform(0, 1, (k, n)).astype(np.float32)
    votes, rvotes = _accumulate_both(k, n, bits, gbar, seed=k + n)
    np.testing.assert_array_equal(votes.numpy(), np.asarray(rvotes))


def test_spfl_accumulate_strided_payload_rows():
    """The transport passes the payload region of framed packets, a
    strided view: same result as the contiguous rows."""
    k, n, bits = 3, 100, 3
    sw, qw, s = _payloads(k, n, bits, seed=5)
    framed = np.concatenate([np.zeros((k, 4), np.uint32), sw,
                             np.ones((k, 1), np.uint32)], axis=1)
    args = (torch.zeros(n), torch.as_tensor(s['gmin']),
            torch.as_tensor(s['gmax']), torch.as_tensor(s['mod_ok']),
            torch.as_tensor(s['weight']), torch.as_tensor(s['sign_ok']),
            n, bits)
    qt = torch.as_tensor(qw.view(np.int32))
    a0, v0 = tops.spfl_aggregate_packed(torch.as_tensor(sw.view(np.int32)),
                                        qt, *args)
    a1, v1 = tops.spfl_aggregate_packed(
        torch.as_tensor(framed.view(np.int32))[:, 4:-1], qt, *args)
    assert torch.equal(a0, a1) and torch.equal(v0, v1)


# the largest f32 below 1: the BER of the largest flip threshold
THRESH_MAX_BER = np.float32(1.0 - 2.0 ** -24)


# The CUDA kernel's edges: one word, 7, one and two 192-thread blocks
# +- 1, the sign packet's width, 32 blocks' threads +- 1 (past it a row's
# blocks loop); 33 clients; word0 where the uint32 word counter wraps
# inside the buffer.
@pytest.mark.parametrize('k,w,word0', [
    (1, 40, 0), (4, 513, 0), (8, 1100, 0), (4, 513, 7 * 513),
    (1, 1, 0), (3, 7, 2 ** 32 - 5), (4, 191, 0), (4, 193, 2 ** 32 - 100),
    (5, 383, 0), (4, 385, 0), (33, 129, 2 ** 32 - 33 * 64), (2, 1943, 0),
    (2, 6143, 0), (2, 6145, 2 ** 32 - 6000)])
def test_corrupt_fold_matches_pallas(k, w, word0):
    rng = np.random.RandomState(k + w)
    words = rng.randint(0, 2 ** 32, (k, w), dtype=np.uint64).astype(np.uint32)
    ber = rng.uniform(0, 0.02, k).astype(np.float32)
    # clean, all-flip and largest-threshold rows
    for row, special in enumerate((0.0, 1.0, THRESH_MAX_BER)[:k - 1], 1):
        ber[row] = special
    key = jax.random.PRNGKey(w + word0 % 65536)
    rx, fold, flips = ops.corrupt_fold_words(
        key, jnp.asarray(words), jnp.asarray(ber), interpret=True,
        use_kernel=True, word0=jnp.uint32(word0))
    grx, gfold, gflips = tops.corrupt_fold_words(
        seeds(key), torch.as_tensor(words.view(np.int32)),
        torch.as_tensor(ber), word0)
    np.testing.assert_array_equal(words_np(grx), np.asarray(rx))
    np.testing.assert_array_equal(words_np(gfold), np.asarray(fold))
    np.testing.assert_array_equal(gflips.numpy(), np.asarray(flips))


@pytest.mark.parametrize('plane', range(32))
def test_plane_constant_identity_matches_hash_bits(plane):
    """corrupt_fold.cu's hoisting: fmix32's first xor-shift of h0 ^ c is
    (h0 ^ h0 >> 16) ^ (c ^ c >> 16), since >> and ^ distribute over ^.
    The kernel's form, in the plain version's 32-bit arithmetic, against
    ``wire.corrupt.hash_bits`` on counters that include both ends of
    uint32."""
    from repro_torch.wire import corrupt as wc
    rng = np.random.RandomState(plane)
    idx = torch.as_tensor(np.concatenate([
        rng.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.int64),
        [0, 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1]]))
    s0, s1 = (int(x) for x in rng.randint(0, 2 ** 32, 2, dtype=np.uint64))
    h0 = wc._fmix32(((idx + wc._GOLDEN) & MASK32) ^ s0) ^ s1
    a = h0 ^ (h0 >> 16)
    c = (plane * wc._PLANE_SALT) & MASK32
    x = a ^ (c ^ (c >> 16))
    x = wc._mul32(x, wc._MIX1)
    x = x ^ (x >> 13)
    x = wc._mul32(x, wc._MIX2)
    x = x ^ (x >> 16)
    assert torch.equal(x, wc.hash_bits(idx, plane, s0, s1))


# w = 1, one cluster's 1,024 threads +- 1 (8 blocks of 128), and 2,049
@pytest.mark.parametrize('k,w', [(1, 512), (3, 100), (5, 1537), (1, 1),
                                 (4, 1), (3, 1025), (20, 1023), (3, 2049)])
def test_fold_words_matches_pallas(k, w):
    rng = np.random.RandomState(k * w)
    words = rng.randint(0, 2 ** 32, (k, w), dtype=np.uint64).astype(np.uint32)
    ref = ops.fold_words(jnp.asarray(words), interpret=True)
    got = tops.fold_words(torch.as_tensor(words.view(np.int32)))
    np.testing.assert_array_equal(words_np(got), np.asarray(ref))


def test_wrappers_check_inputs():
    g = torch.zeros(2, 40)
    with pytest.raises(TypeError):
        tops.quantize_pack_flat(g.double(), g.double(), [0, 0], [1, 1], 3)
    with pytest.raises(ValueError):
        tops.quantize_pack_flat(g, torch.zeros(2, 41), [0, 0], [1, 1], 3)
    with pytest.raises(ValueError):
        tops.spfl_aggregate_packed(
            torch.zeros(2, 2, dtype=torch.int32),
            torch.zeros(2, 6, dtype=torch.int32), torch.zeros(41),
            [0, 0], [1, 1], [1, 1], [1, 1], [True, True], 40, 3)
    with pytest.raises(TypeError):
        tops.fold_words(torch.zeros(2, 3))

