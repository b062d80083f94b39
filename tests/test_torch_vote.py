"""The port's packed-domain sign vote (``repro_torch.wire.vote``) against
``repro.wire.vote`` and an unpacked NumPy count, on the same packed rows
made with NumPy from a seed.

Contract: every word and count bit for bit — the lane masks, the
bit-sliced majority words (strict majority of the gated rows, ties to
-1, the tail word's pad lanes clear) and the per-client disagreement
popcounts — at K = 8, l = 300 (the last word partial, as
``tests/test_adversary.py``), at l = 320 (no partial word), and at
K in {1, 2, 20, 33}, where the number of count bit-planes changes;
with every row voting, with gated-off voters, and with none."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import words_np
from repro.wire import vote as RV
from repro_torch import wire as TW
from repro_torch.wire import vote as TV

KS = (1, 2, 8, 20, 33)


def _rows(k, n, seed, garbage_pad=True):
    """(K, ceil(n/32)) uint32 packed sign rows, pad lanes random (the bit
    channel's flips land there too) unless ``garbage_pad`` is False."""
    rng = np.random.RandomState(seed)
    w = -(-n // 32)
    rows = rng.randint(0, 2 ** 32, size=(k, w), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    if not garbage_pad and n % 32:
        rows[:, -1] &= np.uint32((1 << (n % 32)) - 1)
    return rows


def _bits(rows, n):
    """Unpack (K, W) uint32 rows -> (K, n) 0/1."""
    lanes = np.arange(32, dtype=np.uint32)
    return ((rows[:, :, None] >> lanes) & 1).reshape(rows.shape[0], -1)[:, :n]


def _gates(k):
    rng = np.random.RandomState(k)
    some = rng.rand(k) < 0.7
    some[0] = False                              # at least one voter off
    if k > 1:
        some[-1] = True
    return {'all': np.ones(k, bool), 'some': some, 'none': np.zeros(k, bool)}


@pytest.mark.parametrize('n', [1, 31, 32, 33, 300, 320])
@pytest.mark.parametrize('n_words', [0, 1, 10, 11])
def test_lane_mask_words_matches_reference(n, n_words):
    got = TV.lane_mask_words(n, n_words)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_words,)
    np.testing.assert_array_equal(words_np(got),
                                  np.asarray(RV.lane_mask_words(n, n_words)))


def test_popcount_matches_numpy():
    rng = np.random.RandomState(3)
    w = rng.randint(0, 2 ** 32, size=4096, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 1, 2 ** 32 - 1, 2 ** 31]
    want = np.unpackbits(w.view(np.uint8)).reshape(-1, 32).sum(1)
    got = TV.popcount(torch.as_tensor(w.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('gating', ['all', 'some', 'none'])
@pytest.mark.parametrize('k', KS)
@pytest.mark.parametrize('n', [300, 320])
def test_majority_and_disagreement_match_reference(k, n, gating):
    rows = _rows(k, n, seed=k * 1000 + n)
    gate = _gates(k)[gating]
    maj_r = RV.majority_words(jnp.asarray(rows), jnp.asarray(gate), n)
    dis_r = RV.disagreement(jnp.asarray(rows), maj_r, n)
    t_rows = torch.as_tensor(rows.view(np.int32))
    maj = TV.majority_words(t_rows, torch.as_tensor(gate), n)
    dis = TV.disagreement(t_rows, maj, n)
    assert maj.dtype == torch.int32 and dis.dtype == torch.int32
    np.testing.assert_array_equal(words_np(maj), np.asarray(maj_r))
    np.testing.assert_array_equal(dis.numpy(), np.asarray(dis_r))

    # and both against the unpacked count
    bits = _bits(rows, n)
    votes = bits[gate].sum(axis=0)
    want = (votes > int(gate.sum()) // 2).astype(np.uint32)
    np.testing.assert_array_equal(_bits(words_np(maj)[None], n)[0], want)
    np.testing.assert_array_equal(dis.numpy(), (bits != want).sum(axis=1))
    if n % 32:                                   # pad lanes stay clear
        assert words_np(maj)[-1] >> np.uint32(n % 32) == 0
    if gating == 'none':                         # no voter: all -1
        assert not words_np(maj).any()


@pytest.mark.parametrize('k', [8, 20])
def test_gate_takes_floats_and_strided_rows(k):
    """The gate may be 0/1 floats (the reference's own test passes f32),
    and the rows a strided view of framed packets (``sign_payload``)."""
    n = 300
    rows = _rows(k, n, seed=5 + k)
    framed = np.concatenate([np.zeros((k, 4), np.uint32), rows,
                             np.zeros((k, 1), np.uint32)], axis=1)
    view = torch.as_tensor(framed.view(np.int32))[:, 4:-1]
    assert not view.is_contiguous()
    gate = _gates(k)['some'].astype(np.float32)
    maj = TW.majority_words(view, torch.as_tensor(gate), n)
    maj_r = RV.majority_words(jnp.asarray(rows), jnp.asarray(gate), n)
    np.testing.assert_array_equal(words_np(maj), np.asarray(maj_r))
    np.testing.assert_array_equal(
        TW.disagreement(view, maj, n).numpy(),
        np.asarray(RV.disagreement(jnp.asarray(rows), maj_r, n)))


def test_tie_goes_to_minus_one():
    """Two voters that disagree on every lane: no strict majority."""
    n = 64
    rows = np.array([[0xFFFFFFFF, 0x0000FFFF], [0, 0xFFFF0000]], np.uint32)
    maj = TV.majority_words(torch.as_tensor(rows.view(np.int32)),
                            torch.ones(2, dtype=torch.bool), n)
    assert not words_np(maj).any()
    np.testing.assert_array_equal(
        TV.disagreement(torch.as_tensor(rows.view(np.int32)), maj,
                        n).numpy(), [48, 16])
