"""The port's per-client kernel API (``repro_torch.kernels.ops`` ``*_flat``)
on CPU tensors — where each wrapper runs the plain version of its CUDA
kernel — against the reference's own wrappers with the Pallas kernels in
interpret mode, on the reference tests' grids (tests/test_kernels.py,
tests/test_wire.py).  Inputs are made with numpy from a seed and the
ranges pass to both sides as ``np.float32``.

Contract: signs, knob indices, payload words and unpacked values
bit-exact; f32 outputs within the reference tests' own tolerances, 1e-6
for dequant and unpack_dequant and 1e-5 for the round trip (the reference
computes the knob step inside its kernels, where XLA may contract
gmin + q * step into an FMA).  The identities that ``chip_smoke.py``
phase 6 checks on the card hold bit for bit between the plain versions.
The CUDA kernels themselves are held to the same plain versions on the
card by ``chip_smoke.py`` phase 3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import words_np
from repro.kernels import ops
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.wire import format as tfmt

API = ('quantize', 'dequant', 'roundtrip', 'pack_bits', 'unpack_bits',
       'unpack_dequant')


def _grad(n, seed):
    """g (with g = 0 and g = -0 at coordinates 0 and 1), uniforms, gbar,
    and the range (min |g|, max |g|) as np.float32."""
    rng = np.random.RandomState(seed)
    g = (rng.randn(n) * 0.03).astype(np.float32)
    g[:2] = [0.0, -0.0]
    rand = rng.uniform(0, 1, n).astype(np.float32)
    gbar = (np.abs(rng.randn(n)) * 0.03).astype(np.float32)
    a = np.abs(g)
    return g, rand, gbar, np.float32(a.min()), np.float32(a.max())


def _t(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize('n', [64, 1000, 65539])
@pytest.mark.parametrize('bits', [1, 3, 8])
def test_stochastic_quantize_matches_pallas(n, bits):
    g, rand, _, gmin, gmax = _grad(n, seed=n + bits)
    s, q = ops.stochastic_quantize_flat(jnp.asarray(g), jnp.asarray(rand),
                                        gmin, gmax, bits, interpret=True)
    ts, tq = tops.stochastic_quantize_flat(_t(g), _t(rand), gmin, gmax, bits)
    assert ts.dtype == torch.int8 and tq.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    assert ts[:2].tolist() == [0, 0]             # sign(0) = sign(-0) = 0


@pytest.mark.parametrize('bits', [1, 3, 8])
def test_stochastic_quantize_constant_modulus_matches_pallas(bits):
    """|g| constant: gmin = gmax, knob step 0, every knob index 0."""
    n = 1000
    g = np.where(np.random.RandomState(bits).rand(n) < 0.5, -0.25,
                 0.25).astype(np.float32)
    rand = np.random.RandomState(bits + 1).uniform(0, 1, n).astype(np.float32)
    lo = hi = np.float32(0.25)
    s, q = ops.stochastic_quantize_flat(jnp.asarray(g), jnp.asarray(rand),
                                        lo, hi, bits, interpret=True)
    ts, tq = tops.stochastic_quantize_flat(_t(g), _t(rand), lo, hi, bits)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    assert not tq.any()


@pytest.mark.parametrize('n', [1000, 65543])
@pytest.mark.parametrize('bits', [1, 3, 8])
@pytest.mark.parametrize('mod_ok', [0.0, 1.0])
def test_dequant_compensate_matches_pallas(n, bits, mod_ok):
    _, _, gbar, gmin, gmax = _grad(n, seed=bits)
    rng = np.random.RandomState(n + bits)
    sign = rng.randint(-1, 2, n).astype(np.int8)
    qidx = rng.randint(0, 2 ** bits, n).astype(np.int32)
    out = ops.dequant_compensate_flat(jnp.asarray(sign), jnp.asarray(qidx),
                                      jnp.asarray(gbar), gmin, gmax, mod_ok,
                                      0.77, bits, interpret=True)
    tout = tops.dequant_compensate_flat(_t(sign), _t(qidx), _t(gbar), gmin,
                                        gmax, mod_ok, 0.77, bits)
    assert tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [4096, 70000])
def test_roundtrip_matches_pallas(dtype, n):
    g, rand, gbar, _, _ = _grad(n, seed=7)
    jg, tg = jnp.asarray(g), _t(g)
    if dtype == 'bfloat16':
        jg, tg = jg.astype(jnp.bfloat16), tg.to(torch.bfloat16)
    g32 = np.asarray(jg.astype(jnp.float32))
    np.testing.assert_array_equal(tg.float().numpy(), g32)   # same rounding
    gmin, gmax = np.float32(np.abs(g32).min()), np.float32(np.abs(g32).max())
    out = ops.spfl_roundtrip_flat(jg, jnp.asarray(rand), jnp.asarray(gbar),
                                  gmin, gmax, 1.0, 1.25, 3, interpret=True)
    tout = tops.spfl_roundtrip_flat(tg, _t(rand), _t(gbar), gmin, gmax, 1.0,
                                    1.25, 3)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize('bits,n,wide', [
    (bits, n, False) for bits in (1, 3, 8) for n in (64, 1000, 24581)
] + [(32, 1000, False), (3, 1000, True)])
def test_pack_unpack_bits_match_pallas(bits, n, wide):
    """``wide`` values carry bits above ``bits``, which the pack drops."""
    rng = np.random.RandomState(n + bits)
    top = 2 ** 32 if wide or bits == 32 else 2 ** bits
    v = rng.randint(0, top, n, dtype=np.uint64).astype(np.uint32)
    w = ops.pack_bits_flat(jnp.asarray(v), bits, interpret=True)
    tw = tops.pack_bits_flat(_t(v.astype(np.int64)), bits)
    assert tw.dtype == torch.int32 and tw.shape == (tfmt.n_groups(n) * bits,)
    np.testing.assert_array_equal(words_np(tw), np.asarray(w))
    back = ops.unpack_bits_flat(w, n, bits, interpret=True)
    tback = tops.unpack_bits_flat(tw, n, bits)
    assert tback.dtype == torch.int32
    np.testing.assert_array_equal(words_np(tback), np.asarray(back))
    if not wide:
        np.testing.assert_array_equal(words_np(tback), v)


# the n at which the redesigned pack_bits kernel's warps (GPW groups) and
# blocks (THREADS / 32 warps) end, +-1 group and +-1 value
_PB = build.constants('pack_bits')
_WARP = 32 * _PB['GPW']
_BLOCK = _WARP * _PB['THREADS'] // 32
EDGE_N = (1, 31, 32, 33, _WARP - 32, _WARP - 1, _WARP, _WARP + 1, _WARP + 32,
          _BLOCK - 32, _BLOCK - 1, _BLOCK, _BLOCK + 1, _BLOCK + 32)


@pytest.mark.parametrize('n', EDGE_N + (62006,))
@pytest.mark.parametrize('bits', [1, 3, 16, 32])
def test_pack_unpack_bits_edges_match_pallas(n, bits):
    """Values over the whole uint32 range (the bits at and above ``bits``
    are dropped), at the n where groups, warps and blocks end."""
    v = np.random.RandomState(n * 33 + bits).randint(
        0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    w = ops.pack_bits_flat(jnp.asarray(v), bits, interpret=True)
    tw = tops.pack_bits_flat(_t(v.view(np.int32)), bits)
    assert tw.shape == (tfmt.n_groups(n) * bits,)
    np.testing.assert_array_equal(words_np(tw), np.asarray(w))
    back = ops.unpack_bits_flat(w, n, bits, interpret=True)
    np.testing.assert_array_equal(
        words_np(tops.unpack_bits_flat(tw, n, bits)), np.asarray(back))


@pytest.mark.parametrize('n', [1, 3, 4, 5, 11, 511, 512, 513])
@pytest.mark.parametrize('bits', [1, 3, 16])
@pytest.mark.parametrize('mod_ok', [0.0, 1.0])
def test_dequant_zero_step_matches_pallas_bit_for_bit(n, bits, mod_ok):
    """Constant |g| (gmin = gmax, knob step 0) at n around the vector
    width and a block's tile: gmin + q * 0 and the gbar select leave no
    product that XLA could contract, so both sides agree bit for bit."""
    rng = np.random.RandomState(n + 7 * bits)
    sign = rng.randint(-1, 2, n).astype(np.int8)
    qidx = rng.randint(0, 2 ** bits, n).astype(np.int32)
    gbar = rng.uniform(0, 0.05, n).astype(np.float32)
    lo = hi = np.float32(0.25)
    out = ops.dequant_compensate_flat(jnp.asarray(sign), jnp.asarray(qidx),
                                      jnp.asarray(gbar), lo, hi, mod_ok,
                                      0.77, bits, interpret=True)
    tout = tops.dequant_compensate_flat(_t(sign), _t(qidx), _t(gbar), lo, hi,
                                        mod_ok, 0.77, bits)
    np.testing.assert_array_equal(tout.numpy().view(np.int32),
                                  np.asarray(out).view(np.int32))


@pytest.mark.parametrize('row', [0, 1, 2])
@pytest.mark.parametrize('bits', [1, 3, 32])
def test_pack_unpack_bits_on_row_views_match_pallas(row, bits):
    """Rows of (3, 62,006) values and (3, words) tensors: views whose
    starts are 248,024 B apart (8 mod 16), as phase 6's rows are."""
    n = 62006
    rng = np.random.RandomState(row + 10 * bits)
    v = rng.randint(0, 2 ** 32, (3, n), dtype=np.uint64).astype(np.uint32)
    tv = _t(v.view(np.int32))
    assert tv[row].storage_offset() == row * n
    w = ops.pack_bits_flat(jnp.asarray(v[row]), bits, interpret=True)
    tw = tops.pack_bits_flat(tv[row], bits)
    np.testing.assert_array_equal(words_np(tw), np.asarray(w))
    words = torch.stack([tops.pack_bits_flat(tv[i], bits) for i in range(3)])
    back = ops.unpack_bits_flat(w, n, bits, interpret=True)
    np.testing.assert_array_equal(
        words_np(tops.unpack_bits_flat(words[row], n, bits)),
        np.asarray(back))


@pytest.mark.parametrize('row', [0, 1, 2])
@pytest.mark.parametrize('mod_ok,zero_step', [(0.0, False), (0.0, True),
                                              (1.0, True)])
def test_dequant_on_row_views_matches_pallas_bit_for_bit(row, mod_ok,
                                                         zero_step):
    """Rows of (3, 62,006) sign, knob and gbar tensors (starts at row * n
    B and row * 4 n B: not aligned alike), bit for bit where the knob
    step leaves XLA nothing to contract (mod_ok 0, or step 0)."""
    n, bits = 62006, 3
    rng = np.random.RandomState(row)
    sign = rng.randint(-1, 2, (3, n)).astype(np.int8)
    qidx = rng.randint(0, 2 ** bits, (3, n)).astype(np.int32)
    gbar = rng.uniform(0, 0.05, (3, n)).astype(np.float32)
    lo, hi = ((np.float32(0.25),) * 2 if zero_step
              else (np.float32(0.013), np.float32(0.71)))
    out = ops.dequant_compensate_flat(
        jnp.asarray(sign[row]), jnp.asarray(qidx[row]), jnp.asarray(gbar[row]),
        lo, hi, mod_ok, 1.5, bits, interpret=True)
    ts, tq, tg = _t(sign)[row], _t(qidx)[row], _t(gbar)[row]
    assert tq.storage_offset() == row * n
    tout = tops.dequant_compensate_flat(ts, tq, tg, lo, hi, mod_ok, 1.5, bits)
    np.testing.assert_array_equal(tout.numpy().view(np.int32),
                                  np.asarray(out).view(np.int32))


# the n at which the redesigned quantize and roundtrip kernels' vectors
# (CPT coordinates a thread) and blocks (a tile of CPT * THREADS) end
_QT = build.constants('quantize')
_QTILE = _QT['CPT'] * _QT['THREADS']
QUANTIZE_N = (1, 3, _QT['CPT'] + 1, _QTILE - 1, _QTILE + 1, 62006)


def _edge_grad(n, bits, seed, zero_step):
    """g with g = +-0 at every fifth coordinate and, after the first two,
    g on the knob boundaries gmin + j * step (half of them negative),
    uniforms with 0 at every fourth; or a constant |g| (gmin = gmax, knob
    step 0).  Ranges as np.float32; the step is the IEEE quotient, as in
    both quantizers."""
    rng = np.random.RandomState(seed)
    rand = rng.uniform(0, 1, n).astype(np.float32)
    rand[::4] = 0.0
    if zero_step:
        g = np.where(rng.rand(n) < 0.5, -0.25, 0.25).astype(np.float32)
        return g, rand, np.float32(0.25), np.float32(0.25)
    g = (rng.randn(n) * 0.03).astype(np.float32)
    g[::5] = 0.0
    g[1::10] = -0.0
    a = np.abs(g)
    lo, hi = np.float32(a.min()), np.float32(a.max())
    step = np.float32(np.float32(hi - lo) / np.float32(2 ** bits - 1))
    m = max(0, min(n - 2, 2 ** bits))
    edge = (lo + np.arange(m, dtype=np.float32) * step).astype(np.float32)
    edge[1::2] = -edge[1::2]
    g[2:2 + m] = edge
    return g, rand, lo, hi


def _same_values_and_bits_off_zero(got, want, g):
    """Equal values everywhere, equal bits wherever g != 0: at g = -0 the
    reference's round trip multiplies by jnp.sign(-0) = -0 and gives -0,
    the port's gives +0, as dequant(quantize()) does on both sides (the
    int8 sign of g = +-0 is 0)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got, want)
    live = g != 0
    np.testing.assert_array_equal(got.view(np.int32)[live],
                                  want.view(np.int32)[live])


@pytest.mark.parametrize('n', QUANTIZE_N)
@pytest.mark.parametrize('bits', [1, 3, 16])
@pytest.mark.parametrize('zero_step', [False, True])
def test_stochastic_quantize_at_signed_zeros_and_knob_edges(n, bits,
                                                           zero_step):
    """g = +-0 (sign 0) and g on the knob boundaries, at n around the
    redesigned kernel's vector width and tile: sign and knob index bit
    for bit."""
    g, rand, lo, hi = _edge_grad(n, bits, 3 * n + bits, zero_step)
    s, q = ops.stochastic_quantize_flat(jnp.asarray(g), jnp.asarray(rand),
                                        lo, hi, bits, interpret=True)
    ts, tq = tops.stochastic_quantize_flat(_t(g), _t(rand), lo, hi, bits)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    assert not ts.numpy()[g == 0].any()          # sign(0) = sign(-0) = 0


@pytest.mark.parametrize('n', [1, 5, 513, 62006])
@pytest.mark.parametrize('mod_ok,zero_step', [(0.0, False), (0.0, True),
                                              (1.0, True), (1.0, False)])
def test_roundtrip_mod_ok_and_zero_step_match_pallas(n, mod_ok, zero_step):
    """The round trip at mod_ok 0 (the output is (w * s) * gbar) and at
    a zero knob step (gmin + q * 0 = gmin): no product is left for XLA
    to contract, so both sides agree bit for bit (but for the sign of a
    zero output at g = -0, ``_same_values_and_bits_off_zero``); at mod_ok
    1 with a live step within 1e-6 (XLA may fuse gmin + q * step into an
    FMA)."""
    bits = 3
    g, rand, lo, hi = _edge_grad(n, bits, n + int(mod_ok), zero_step)
    gbar = np.random.RandomState(n).uniform(0, 0.05, n).astype(np.float32)
    out = ops.spfl_roundtrip_flat(jnp.asarray(g), jnp.asarray(rand),
                                  jnp.asarray(gbar), lo, hi, mod_ok, 1.25,
                                  bits, interpret=True)
    tout = tops.spfl_roundtrip_flat(_t(g), _t(rand), _t(gbar), lo, hi,
                                    mod_ok, 1.25, bits)
    if mod_ok and not zero_step:
        np.testing.assert_allclose(tout.numpy(), np.asarray(out), rtol=0,
                                   atol=1e-6)
    else:
        _same_values_and_bits_off_zero(tout.numpy(), out, g)


@pytest.mark.parametrize('row', [0, 1, 2])
@pytest.mark.parametrize('mod_ok', [0.0, 1.0])
def test_quantize_and_roundtrip_on_row_views_match_pallas(row, mod_ok):
    """Rows of (3, 62,006) g and uniform tensors (starts 248,024 B apart:
    8 mod 16, as phase 6's rows) with an aligned gbar: quantize bit for
    bit; the round trip bit for bit at mod_ok 0 (off g = +-0), within
    1e-6 at mod_ok 1 (XLA may contract gmin + q * step)."""
    n, bits = 62006, 3
    rng = np.random.RandomState(row)
    g = (rng.randn(3, n) * 0.02).astype(np.float32)
    g[:, :2] = [0.0, -0.0]
    rand = rng.uniform(0, 1, (3, n)).astype(np.float32)
    gbar = rng.uniform(0, 0.05, n).astype(np.float32)
    a = np.abs(g[row])
    lo, hi = np.float32(a.min()), np.float32(a.max())
    tg, tr = _t(g)[row], _t(rand)[row]
    assert tg.storage_offset() == row * n and tr.storage_offset() == row * n
    s, q = ops.stochastic_quantize_flat(jnp.asarray(g[row]),
                                        jnp.asarray(rand[row]), lo, hi, bits,
                                        interpret=True)
    ts, tq = tops.stochastic_quantize_flat(tg, tr, lo, hi, bits)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    out = ops.spfl_roundtrip_flat(jnp.asarray(g[row]), jnp.asarray(rand[row]),
                                  jnp.asarray(gbar), lo, hi, mod_ok, 0.6,
                                  bits, interpret=True)
    tout = tops.spfl_roundtrip_flat(tg, tr, _t(gbar), lo, hi, mod_ok, 0.6,
                                    bits)
    if mod_ok:
        np.testing.assert_allclose(tout.numpy(), np.asarray(out), rtol=0,
                                   atol=1e-6)
    else:
        _same_values_and_bits_off_zero(tout.numpy(), out, g[row])


@pytest.mark.parametrize('mod_ok', [0.0, 1.0])
def test_unpack_dequant_matches_pallas(mod_ok):
    n, bits, weight = 8192 + 7, 3, 1.7
    g, rand, gbar, gmin, gmax = _grad(n, seed=21)
    sw, qw = ops.quantize_pack_flat(jnp.asarray(g), jnp.asarray(rand), gmin,
                                    gmax, bits, interpret=True)
    out = ops.unpack_dequant_flat(sw, qw, jnp.asarray(gbar), gmin, gmax,
                                  mod_ok, weight, n, bits, interpret=True)
    tout = tops.unpack_dequant_flat(
        _t(np.array(sw).view(np.int32)), _t(np.array(qw).view(np.int32)),
        _t(gbar), gmin, gmax, mod_ok, weight, n, bits)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('bits', [1, 3, 8])
def test_kernel_api_identities_bit_exact(bits):
    """``chip_smoke.py`` phase 6 at k=3, n=1007 on the plain versions:
    (a) pack_bits(qidx) = quantize_pack's knob words; (b) the packed sign
    bits (0 transmits as 1) = its sign words; (c) unpack(pack(qidx)) =
    qidx; (d) roundtrip = dequant(quantize()); (e) the in-order f32 sum of
    unpack_dequant = spfl_aggregate_packed's sum.  Client 1 has a
    constant |g| (knob step 0)."""
    k, n = 3, 1007
    rng = np.random.RandomState(bits)
    g = (rng.randn(k, n) * 0.01).astype(np.float32)
    g[:, :2] = [0.0, -0.0]
    g[1] = -0.25
    g, rand = _t(g), _t(rng.uniform(0, 1, (k, n)).astype(np.float32))
    gbar = _t((rng.uniform(0, 0.01, n)).astype(np.float32))
    gmin, gmax = g.abs().amin(1), g.abs().amax(1)
    mod_ok = torch.tensor([1.0, 0.0, 1.0])
    weight = torch.linspace(0.5, 2.0, k)
    sw, qw = tops.quantize_pack_flat(g, rand, gmin, gmax, bits)
    acc = None
    for i in range(k):
        args = (gmin[i], gmax[i], mod_ok[i], weight[i])
        sign, qidx = tops.stochastic_quantize_flat(g[i], rand[i], gmin[i],
                                                   gmax[i], bits)
        words = tops.pack_bits_flat(qidx, bits)
        assert torch.equal(words, qw[i])                                 # (a)
        assert torch.equal(
            tops.pack_bits_flat(tfmt.sign_to_bits(sign), 1), sw[i])      # (b)
        assert torch.equal(tops.unpack_bits_flat(words, n, bits), qidx)  # (c)
        assert torch.equal(
            tops.spfl_roundtrip_flat(g[i], rand[i], gbar, *args, bits),
            tops.dequant_compensate_flat(sign, qidx, gbar, *args, bits))  # (d)
        contrib = tops.unpack_dequant_flat(sw[i], qw[i], gbar, *args, n,
                                           bits)
        acc = contrib if i == 0 else acc + contrib
    agg, _ = tops.spfl_aggregate_packed(sw, qw, gbar, gmin, gmax, mod_ok,
                                        weight, torch.ones(k, dtype=torch.bool),
                                        n, bits)
    assert torch.equal(acc, agg)                                          # (e)
    assert all(tops.launch_counts[name] == 0 for name in API)   # CPU: plain


def test_launch_counts_stay_zero_on_the_cpu():
    tops.reset_launch_counts()
    g, rand, gbar, gmin, gmax = _grad(100, seed=3)
    g, rand, gbar = _t(g), _t(rand), _t(gbar)
    sign, qidx = tops.stochastic_quantize_flat(g, rand, gmin, gmax, 3)
    tops.dequant_compensate_flat(sign, qidx, gbar, gmin, gmax, 1.0, 1.0, 3)
    tops.spfl_roundtrip_flat(g, rand, gbar, gmin, gmax, 1.0, 1.0, 3)
    sw = tops.pack_bits_flat(tfmt.sign_to_bits(sign), 1)
    qw = tops.pack_bits_flat(qidx, 3)
    tops.unpack_bits_flat(qw, 100, 3)
    tops.unpack_dequant_flat(sw, qw, gbar, gmin, gmax, 1.0, 1.0, 100, 3)
    assert set(API) <= set(tops.launch_counts)
    assert all(c == 0 for c in tops.launch_counts.values())


@pytest.mark.parametrize('call,error', [
    (lambda: tops.unpack_bits_flat(torch.zeros(9, dtype=torch.int32), 64, 3),
     ValueError),                                      # 2 groups x 3 = 6
    (lambda: tops.unpack_dequant_flat(
        torch.zeros(2, dtype=torch.int32), torch.zeros(5, dtype=torch.int32),
        torch.zeros(64), 0.0, 1.0, 1.0, 1.0, 64, 3), ValueError),
    (lambda: tops.unpack_dequant_flat(
        torch.zeros(3, dtype=torch.int32), torch.zeros(6, dtype=torch.int32),
        torch.zeros(64), 0.0, 1.0, 1.0, 1.0, 64, 3), ValueError),
    (lambda: tops.stochastic_quantize_flat(torch.zeros(8), torch.zeros(8),
                                           0.0, 1.0, 0), ValueError),
    (lambda: tops.stochastic_quantize_flat(torch.zeros(8), torch.zeros(8),
                                           0.0, 1.0, 17), ValueError),
    (lambda: tops.dequant_compensate_flat(
        torch.zeros(8, dtype=torch.int8), torch.zeros(8, dtype=torch.int32),
        torch.zeros(8), 0.0, 1.0, 1.0, 1.0, 17), ValueError),
    (lambda: tops.spfl_roundtrip_flat(torch.zeros(8), torch.zeros(8),
                                      torch.zeros(8), 0.0, 1.0, 1.0, 1.0, 0),
     ValueError),
    (lambda: tops.pack_bits_flat(torch.zeros(8, dtype=torch.int32), 33),
     ValueError),
    (lambda: tops.unpack_bits_flat(torch.zeros(0, dtype=torch.int32), 0, 0),
     ValueError),
    (lambda: tops.stochastic_quantize_flat(torch.zeros(2, 4),
                                           torch.zeros(2, 4), 0.0, 1.0, 3),
     ValueError),                                      # not flat
    (lambda: tops.stochastic_quantize_flat(torch.zeros(8), torch.zeros(9),
                                           0.0, 1.0, 3), ValueError),
    (lambda: tops.dequant_compensate_flat(
        torch.zeros(8, dtype=torch.int8), torch.zeros(8, dtype=torch.int32),
        torch.zeros(7), 0.0, 1.0, 1.0, 1.0, 3), ValueError),
])
def test_wrappers_reject_bad_inputs(call, error):
    with pytest.raises(error):
        call()


# n around a group, around the end of a warp of unpack_dequant's vectors
# (32 vectors of 4 coordinates), and the main width
UNPACK_N = (1, 31, 32, 33, 127, 129, 62006)


def _payload(lead, n, bits, seed):
    """Arbitrary sign and knob payload words (np.uint32, shapes lead +
    (G,) and lead + (G * bits,)) and gbar in [0, 0.05)."""
    rng = np.random.RandomState(seed)
    g = tfmt.n_groups(n)
    sw = rng.randint(0, 2 ** 32, lead + (g,), dtype=np.uint64)
    qw = rng.randint(0, 2 ** 32, lead + (g * bits,), dtype=np.uint64)
    gbar = rng.uniform(0, 0.05, n).astype(np.float32)
    return sw.astype(np.uint32), qw.astype(np.uint32), gbar


def _range(zero_step):
    return ((np.float32(0.25),) * 2 if zero_step
            else (np.float32(0.013), np.float32(0.71)))


@pytest.mark.parametrize('n', UNPACK_N)
@pytest.mark.parametrize('bits', [1, 3, 16])
@pytest.mark.parametrize('mod_ok,zero_step', [(0.0, False), (0.0, True),
                                              (1.0, True)])
def test_unpack_dequant_matches_pallas_bit_for_bit(n, bits, mod_ok,
                                                   zero_step):
    """Arbitrary payload words at n around a group and a warp's vectors:
    at mod_ok 0 (w * (s * gbar)) or a zero knob step (gmin + q * 0) XLA
    has no product to contract, so both sides agree bit for bit."""
    sw, qw, gbar = _payload((), n, bits, seed=n + 17 * bits)
    lo, hi = _range(zero_step)
    out = ops.unpack_dequant_flat(jnp.asarray(sw), jnp.asarray(qw),
                                  jnp.asarray(gbar), lo, hi, mod_ok, 0.77, n,
                                  bits, interpret=True)
    tout = tops.unpack_dequant_flat(_t(sw.view(np.int32)),
                                    _t(qw.view(np.int32)), _t(gbar), lo, hi,
                                    mod_ok, 0.77, n, bits)
    np.testing.assert_array_equal(tout.numpy().view(np.int32),
                                  np.asarray(out).view(np.int32))


@pytest.mark.parametrize('row', [0, 1, 2])
@pytest.mark.parametrize('mod_ok,zero_step', [(0.0, False), (0.0, True),
                                              (1.0, True)])
def test_unpack_dequant_on_row_views_matches_pallas_bit_for_bit(
        row, mod_ok, zero_step):
    """Rows of (3, G) sign and (3, G * bits) knob word tensors (starts
    7,752 B and 23,256 B apart: 8 mod 16, as phase 6's rows), bit for bit
    where the knob step leaves XLA nothing to contract."""
    n, bits = 62006, 3
    sw, qw, gbar = _payload((3,), n, bits, seed=row)
    lo, hi = _range(zero_step)
    out = ops.unpack_dequant_flat(jnp.asarray(sw[row]), jnp.asarray(qw[row]),
                                  jnp.asarray(gbar), lo, hi, mod_ok, 1.5, n,
                                  bits, interpret=True)
    tsw, tqw = _t(sw.view(np.int32))[row], _t(qw.view(np.int32))[row]
    assert tqw.storage_offset() * 4 % 16 == (8 if row % 2 else 0)
    tout = tops.unpack_dequant_flat(tsw, tqw, _t(gbar), lo, hi, mod_ok, 1.5,
                                    n, bits)
    np.testing.assert_array_equal(tout.numpy().view(np.int32),
                                  np.asarray(out).view(np.int32))


@pytest.mark.parametrize('bits', [1, 3, 16])
@pytest.mark.parametrize('mod_ok', [0.0, 1.0])
def test_unpack_dequant_takes_gmax_and_makes_the_knob_step(bits, mod_ok):
    """``unpack_dequant_flat(gmin, gmax)`` equals the plain version given
    the knob step ``knob_step(gmin, gmax)`` (the IEEE quotient that the
    kernel computes), bit for bit, here through the plain path."""
    from repro_torch.core.quantize import knob_step
    from repro_torch.kernels import ref
    n = 1000
    sw, qw, gbar = _payload((), n, bits, seed=bits)
    tsw, tqw = _t(sw.view(np.int32)), _t(qw.view(np.int32))
    lo, hi = torch.tensor([0.013]), torch.tensor([0.71])
    args = (torch.tensor([mod_ok]), torch.tensor([0.77]))
    got = tops.unpack_dequant_flat(tsw, tqw, _t(gbar), lo, hi, *args, n,
                                   bits)
    want = ref.unpack_dequant(tsw, tqw, _t(gbar), lo, knob_step(lo, hi, bits),
                              *args, n, bits)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))
