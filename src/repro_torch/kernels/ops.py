"""Wrappers around the hand-written CUDA kernels (the port of
``repro.kernels.ops``): the four kernels of the packed, bit-level round,
the per-client kernel API (``*_flat``: the unfused quantizer and
dequantizer, the fused analytic round trip, the bit-plane packers and
the single-client packed decode), and the on-device eq. (28) solver
(``alloc_solve``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, and then:

* for tensors on a CUDA card, launches its kernel on the current stream
  (building it at first use, ``kernels.build``) and raises if the launch
  fails — it never falls back;
* for tensors on the CPU, calls the plain version in ``kernels.ref``.

``launch_counts`` counts successful kernel launches per kernel; a run
resets it with :func:`reset_launch_counts` and reads it afterwards to
show that its path went through the kernels.  Plain-version calls are not
counted.  A launch issued into a CUDA graph being captured counts once,
there; the graph's replays do not pass through the wrappers.

Words are int32 tensors holding uint32 bit patterns (``wire.format``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.quantize import knob_step
from repro_torch.kernels import build, ref
from repro_torch.wire import corrupt as wire_corrupt
from repro_torch.wire import format as fmt

Tensor = torch.Tensor

MAX_VOTE_CLIENTS = 32        # vote word capacity: one bit per client

launch_counts = {name: 0 for name in build.KERNELS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _on_card(*tensors: Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; anything else, or a
    mix of devices, raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f'tensors on several devices: {sorted(map(str, devices))}')
    dev = devices.pop()
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev}')
    return dev.type == 'cuda'


def _expect(t: Tensor, name: str, dtype, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f'{name}: expected {dtype}, got {t.dtype}')
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, '
                         f'got {tuple(t.shape)}')


def _rows(t: Tensor, name: str) -> int:
    """Row stride of a (K, W) tensor whose rows are unit-stride."""
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f'{name}: expected (K, W) rows with unit stride')
    return t.stride(0)


def _contig(t: Tensor, name: str) -> Tensor:
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')
    return t


def _launch(name: str, t: Tensor, *args) -> None:
    fn = build.kernel(name)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with error {rc}')
    launch_counts[name] += 1


def _col(x, k: int, dtype, device) -> Tensor:
    """Per-client scalars (K,) as a contiguous tensor of ``dtype``."""
    return torch.as_tensor(x, device=device).to(dtype).reshape(k).contiguous()


def _scalar(x, device) -> Tensor:
    """One client's scalar (a number or a one-element tensor) as a
    one-element f32 tensor on ``device``: the kernel reads it by pointer,
    so a card tensor is never read back to the host."""
    return _col(x, 1, torch.float32, device)


def _flat(t: Tensor, name: str) -> Tensor:
    if t.dim() != 1:
        raise ValueError(f'{name}: expected a flat (n,) tensor, '
                         f'got shape {tuple(t.shape)}')
    return t


def _bits(bits: int, most: int) -> None:
    if not 1 <= bits <= most:
        raise ValueError(f'bits must be in [1, {most}], got {bits}')


# ---------------------------------------------------------------------------
# the per-client kernel API (one client's flat vector per call)
# ---------------------------------------------------------------------------

def stochastic_quantize_flat(g: Tensor, rand: Tensor, gmin, gmax,
                             bits: int) -> Tuple[Tensor, Tensor]:
    """One client's flat (n,) gradient (cast to f32) and uniforms ->
    (sign int8 (n,) in {-1, 0, +1}, knob index int32 (n,)), eq. (8)."""
    _bits(bits, 16)
    g = _flat(g, 'g').to(torch.float32)
    rand = rand.to(torch.float32)
    _expect(rand, 'rand', torch.float32, g.shape)
    gmin, gmax = _scalar(gmin, g.device), _scalar(gmax, g.device)
    if not _on_card(g, rand, gmin, gmax):
        return ref.quantize(g, rand, gmin, gmax, bits)
    _contig(g, 'g'), _contig(rand, 'rand')
    n = g.shape[0]
    sign = torch.empty((n,), dtype=torch.int8, device=g.device)
    qidx = torch.empty((n,), dtype=torch.int32, device=g.device)
    _launch('quantize', g, g.data_ptr(), rand.data_ptr(), gmin.data_ptr(),
            gmax.data_ptr(), sign.data_ptr(), qidx.data_ptr(), n, bits)
    return sign, qidx


def dequant_compensate_flat(sign: Tensor, qidx: Tensor, gbar: Tensor,
                            gmin, gmax, mod_ok, weight, bits: int) -> Tensor:
    """One client's weighted, compensated contribution from its sign and
    knob indices, eq. (15)-(17): (w * s) * (mod_ok ? gmin + q * step :
    gbar), (n,) f32, with the knob step computed in the kernel."""
    _bits(bits, 16)
    sign = _flat(sign, 'sign').to(torch.int8)
    qidx = qidx.to(torch.int32)
    gbar = gbar.to(torch.float32)
    _expect(qidx, 'qidx', torch.int32, sign.shape)
    _expect(gbar, 'gbar', torch.float32, sign.shape)
    dev = sign.device
    gmin, gmax = _scalar(gmin, dev), _scalar(gmax, dev)
    mod_ok, weight = _scalar(mod_ok, dev), _scalar(weight, dev)
    if not _on_card(sign, qidx, gbar, gmin):
        return ref.dequant(sign, qidx, gbar, gmin, gmax, mod_ok, weight,
                           bits)
    _contig(sign, 'sign'), _contig(qidx, 'qidx'), _contig(gbar, 'gbar')
    n = sign.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    _launch('dequant', sign, sign.data_ptr(), qidx.data_ptr(),
            gbar.data_ptr(), gmin.data_ptr(), gmax.data_ptr(),
            mod_ok.data_ptr(), weight.data_ptr(), out.data_ptr(), n, bits)
    return out


def spfl_roundtrip_flat(g: Tensor, rand: Tensor, gbar: Tensor, gmin, gmax,
                        mod_ok, weight, bits: int) -> Tensor:
    """Fused client + PS pass of one client: the weighted, compensated
    contribution of ``dequant_compensate_flat(*stochastic_quantize_flat())``
    in one pass, with no sign or knob intermediate; g may be bf16."""
    _bits(bits, 16)
    g = _flat(g, 'g').to(torch.float32)
    rand, gbar = rand.to(torch.float32), gbar.to(torch.float32)
    _expect(rand, 'rand', torch.float32, g.shape)
    _expect(gbar, 'gbar', torch.float32, g.shape)
    dev = g.device
    gmin, gmax = _scalar(gmin, dev), _scalar(gmax, dev)
    mod_ok, weight = _scalar(mod_ok, dev), _scalar(weight, dev)
    if not _on_card(g, rand, gbar, gmin):
        return ref.roundtrip(g, rand, gbar, gmin, gmax, mod_ok, weight,
                             bits)
    _contig(g, 'g'), _contig(rand, 'rand'), _contig(gbar, 'gbar')
    n = g.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    _launch('roundtrip', g, g.data_ptr(), rand.data_ptr(), gbar.data_ptr(),
            gmin.data_ptr(), gmax.data_ptr(), mod_ok.data_ptr(),
            weight.data_ptr(), out.data_ptr(), n, bits)
    return out


def pack_bits_flat(values: Tensor, bits: int) -> Tensor:
    """(n,) integer values -> (ceil(n/32) * bits,) payload words, int32
    patterns in the canonical layout; bits at and above ``bits`` are
    dropped."""
    _bits(bits, 32)
    values = fmt.to_words(_flat(values, 'values'))
    if not _on_card(values):
        return ref.pack_bits(values, bits)
    _contig(values, 'values')
    n = values.shape[0]
    words = torch.empty((fmt.payload_words(n, bits),), dtype=torch.int32,
                        device=values.device)
    _launch('pack_bits', values, values.data_ptr(), words.data_ptr(), n,
            bits)
    return words


def unpack_bits_flat(words: Tensor, n: int, bits: int) -> Tensor:
    """Inverse of :func:`pack_bits_flat` -> (n,) values as int32 patterns
    (the reference's uint32 values)."""
    _bits(bits, 32)
    words = fmt.to_words(_flat(words, 'words'))
    _expect(words, 'words', torch.int32, (fmt.payload_words(n, bits),))
    if not _on_card(words):
        return ref.unpack_bits(words, n, bits)
    _contig(words, 'words')
    values = torch.empty((n,), dtype=torch.int32, device=words.device)
    _launch('unpack_bits', words, words.data_ptr(), values.data_ptr(), n,
            bits)
    return values


def unpack_dequant_flat(sign_words: Tensor, qidx_words: Tensor,
                        gbar: Tensor, gmin, gmax, mod_ok, weight, n: int,
                        bits: int) -> Tensor:
    """Fused PS decode of one client from its packed payload words:
    w * (s * (mod_ok ? gmin + q * step : gbar)), (n,) f32, with the knob
    step (an IEEE division) computed in the kernel: on the card a call
    is one device operation.  On the CPU the plain version takes the
    step from ``quantize.knob_step``."""
    _bits(bits, 16)
    groups = fmt.n_groups(n)
    sign_words = fmt.to_words(_flat(sign_words, 'sign_words'))
    qidx_words = fmt.to_words(_flat(qidx_words, 'qidx_words'))
    _expect(sign_words, 'sign_words', torch.int32, (groups,))
    _expect(qidx_words, 'qidx_words', torch.int32, (groups * bits,))
    gbar = gbar.to(torch.float32)
    _expect(gbar, 'gbar', torch.float32, (n,))
    dev = sign_words.device
    gmin, gmax = _scalar(gmin, dev), _scalar(gmax, dev)
    mod_ok, weight = _scalar(mod_ok, dev), _scalar(weight, dev)
    if not _on_card(sign_words, qidx_words, gbar, gmin):
        return ref.unpack_dequant(sign_words, qidx_words, gbar, gmin,
                                  knob_step(gmin, gmax, bits), mod_ok,
                                  weight, n, bits)
    for t, name in ((sign_words, 'sign_words'), (qidx_words, 'qidx_words'),
                    (gbar, 'gbar')):
        _contig(t, name)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    _launch('unpack_dequant', sign_words, sign_words.data_ptr(),
            qidx_words.data_ptr(), gbar.data_ptr(), gmin.data_ptr(),
            gmax.data_ptr(), mod_ok.data_ptr(), weight.data_ptr(),
            out.data_ptr(), n, bits)
    return out


# ---------------------------------------------------------------------------
# client side: fused quantize + pack (K clients)
# ---------------------------------------------------------------------------

def quantize_pack_flat(g: Tensor, rand: Tensor, gmin, gmax, bits: int
                       ) -> Tuple[Tensor, Tensor]:
    """Fused client pass for K clients: (K, n) f32 gradients and uniforms,
    per-client ranges (K,) -> packed (sign words (K, G), knob words
    (K, G * bits)), G = ceil(n / 32)."""
    if g.dim() != 2:
        raise ValueError('g: expected (K, n)')
    k, n = g.shape
    _expect(g, 'g', torch.float32)
    _expect(rand, 'rand', torch.float32, g.shape)
    if not 1 <= bits <= 16:
        raise ValueError(f'bits must be in [1, 16], got {bits}')
    gmin = _col(gmin, k, torch.float32, g.device)
    gmax = _col(gmax, k, torch.float32, g.device)
    if _on_card(g, rand, gmin, gmax):
        _contig(g, 'g'), _contig(rand, 'rand')
        groups = fmt.n_groups(n)
        sw = torch.empty((k, groups), dtype=torch.int32, device=g.device)
        qw = torch.empty((k, groups * bits), dtype=torch.int32,
                         device=g.device)
        _launch('quantize_pack', g, g.data_ptr(), rand.data_ptr(),
                gmin.data_ptr(), gmax.data_ptr(), sw.data_ptr(),
                qw.data_ptr(), k, n, bits)
    else:
        sw, qw = ref.quantize_pack(g, rand, gmin, gmax, bits)
    return sw, qw


# ---------------------------------------------------------------------------
# PS side: decode-once aggregation
# ---------------------------------------------------------------------------

def spfl_aggregate_packed(sign_payload: Tensor, qidx_payload: Tensor,
                          gbar: Tensor, gmin, gmax, mod_ok, weight,
                          sign_ok, n: int, bits: int
                          ) -> Tuple[Tensor, Optional[Tensor]]:
    """Decode-once PS aggregation, eq. (15)-(17), from the packed domain:

        (sum_k w_k * s(g_k) ⊙ (mod_ok_k ? Q_v(g_k) : gbar),  sign votes)

    ``sign_payload`` (K, ceil(n/32)) and ``qidx_payload``
    (K, ceil(n/32) * bits) are payload words (rows may be strided views
    of framed packets); ``gbar`` is (n,) shared or (K, n) per client; the
    per-client scalars are (K,).  Votes (int32, per-coordinate count of
    accepted +1 signs) are ``None`` when K exceeds the 32-client vote
    word.  The knob step is computed here with
    ``quantize.knob_step`` (IEEE division), as the reference does."""
    k = sign_payload.shape[0]
    groups = fmt.n_groups(n)
    _expect(sign_payload, 'sign_payload', torch.int32, (k, groups))
    _expect(qidx_payload, 'qidx_payload', torch.int32, (k, groups * bits))
    _expect(gbar, 'gbar', torch.float32)
    if tuple(gbar.shape) not in ((n,), (k, n)):
        raise ValueError(f'gbar: expected ({n},) or ({k}, {n}), '
                         f'got {tuple(gbar.shape)}')
    with_votes = k <= MAX_VOTE_CLIENTS
    dev = sign_payload.device
    gmin = _col(gmin, k, torch.float32, dev)
    step = knob_step(gmin, _col(gmax, k, torch.float32, dev), bits)
    mod_ok = _col(mod_ok, k, torch.float32, dev)
    weight = _col(weight, k, torch.float32, dev)
    gate = _col(sign_ok, k, torch.int32, dev)
    if not _on_card(sign_payload, qidx_payload, gbar, gmin):
        return ref.spfl_accumulate(sign_payload, qidx_payload, gbar, gmin,
                                   step, mod_ok, weight, gate, n, bits,
                                   with_votes)
    _contig(gbar, 'gbar')
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    votes = (torch.empty((n,), dtype=torch.int32, device=dev)
             if with_votes else None)
    _launch('spfl_accumulate', sign_payload, sign_payload.data_ptr(),
            _rows(sign_payload, 'sign_payload'), qidx_payload.data_ptr(),
            _rows(qidx_payload, 'qidx_payload'), gbar.data_ptr(),
            n if gbar.dim() == 2 else 0, gmin.data_ptr(), step.data_ptr(),
            mod_ok.data_ptr(), weight.data_ptr(), gate.data_ptr(),
            out.data_ptr(), votes.data_ptr() if with_votes else None,
            k, n, bits)
    return out, votes


# ---------------------------------------------------------------------------
# the bit channel and the PS CRC verify
# ---------------------------------------------------------------------------

# (device, stream) -> (K, 2) int64 accumulators per client row, zero
# between launches: a launch zeroes those it fills before it ends, and
# the launches of one stream run one after another, so each stream has
# its own.  A launch the card refuses never touches them; a kernel that
# faults leaves the device unusable, so none runs on dirty ones.
_accumulators = {}


def corrupt_fold_accumulators(k: int, device) -> Tensor:
    """The (>= k, 2) int64 accumulators of a corrupt_fold launch on the
    current stream of ``device`` (its rows' fold and count, each with the
    row's block bitmap or ticket), zeroed once, when first made for as
    many rows on that stream."""
    device = torch.device(device)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    acc = _accumulators.get(key)
    if acc is None or acc.shape[0] < k:
        acc = _accumulators[key] = torch.zeros((k, 2), dtype=torch.int64,
                                               device=device)
    return acc


def seed_words(seeds, device) -> Tensor:
    """Seed pairs (Python ints: one pair, or a sequence of pairs) as the
    int32 tensor of their uint32 patterns on ``device`` that
    :func:`corrupt_fold_words` reads: (2,) or (n, 2).  One copy from the
    host; the training loop's draws make theirs in one copy a round."""
    return fmt.to_words(torch.as_tensor(seeds, dtype=torch.int64)
                        & fmt.MASK32).to(device)


def corrupt_fold_words(seeds, words: Tensor, ber,
                       word0: int = 0) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused bit-channel pass over (K, W) word buffers at per-client BER
    ``ber`` (scalar or (K,)) with the counter PRF keyed by two uint32
    seed words: ``seeds`` is a (2,) int32 tensor of their patterns on the
    words' device (read by the kernel from device memory, so a captured
    launch replays with whatever the tensor holds), or a pair of Python
    ints, copied there first (:func:`seed_words`).  ``word0`` offsets the
    global word counter.  -> (received (K, W), per-client flip-mask
    xor-fold (K,), per-client flip count (K,)), all int32.  On the card
    it launches one kernel besides the threshold arithmetic: the kernel
    writes every output."""
    _expect(words, 'words', torch.int32)
    if words.dim() != 2:
        raise ValueError('words: expected (K, W)')
    k, w = words.shape
    if not isinstance(seeds, Tensor):
        seeds = seed_words(seeds, words.device)
    _expect(seeds, 'seeds', torch.int32, (2,))
    thresh, allf = wire_corrupt.flip_threshold(
        torch.as_tensor(ber, dtype=torch.float32,
                        device=words.device).expand(k))
    thresh = fmt.to_words(thresh).contiguous()
    allf = allf.to(torch.int32).contiguous()
    word0 = int(word0) & fmt.MASK32
    if not _on_card(words, thresh, seeds):
        return ref.corrupt_fold(seeds, words, thresh, allf, word0)
    _contig(words, 'words'), _contig(seeds, 'seeds')
    rx = torch.empty_like(words)
    fold = torch.empty((k,), dtype=torch.int32, device=words.device)
    flips = torch.empty((k,), dtype=torch.int32, device=words.device)
    acc = corrupt_fold_accumulators(k, words.device)
    _launch('corrupt_fold', words, words.data_ptr(), rx.data_ptr(),
            thresh.data_ptr(), allf.data_ptr(), acc.data_ptr(),
            fold.data_ptr(), flips.data_ptr(), k, w, seeds.data_ptr(), word0)
    return rx, fold, flips


def fold_words(words: Tensor) -> Tensor:
    """Per-client xor-fold of (K, W) word buffers -> (K,) int32: the PS
    CRC reduction of the bit-level transport."""
    _expect(words, 'words', torch.int32)
    if words.dim() != 2:
        raise ValueError('words: expected (K, W)')
    k, w = words.shape
    if not _on_card(words):
        return ref.fold_words(words)
    out = torch.empty((k,), dtype=torch.int32, device=words.device)
    _launch('fold_words', words, words.data_ptr(), _rows(words, 'words'),
            out.data_ptr(), k, w)
    return out


# ---------------------------------------------------------------------------
# the on-device eq. (28) solver
# ---------------------------------------------------------------------------

# the sequential function's trips, then the speculative golden sections
# of the dual search that its walk did not take
ALLOC_TRIPS = ('outer', 'alpha', 'chains', 'newton', 'sca', 'dual', 'grow',
               'bisect', 'golden', 'eval', 'barrier', 'backtrack',
               'objective', 'spec_golden')
ALLOC_LAYOUT = ('threads', 'lanes', 'groups', 'parts', 'cluster', 'nodes',
                'depth')


@functools.lru_cache(maxsize=1)
def alloc_limits() -> dict:
    """The solver kernel's limits, read from its source: MAX_K clients a
    problem, MAX_ITERS outer iterations."""
    return build.constants('alloc_solve')


# the solver kernel of each dtype: (kernel name, C scalar type, layout
# entry point)
_ALLOC_KERNELS = {
    torch.float64: ('alloc_solve', ctypes.c_double, 'alloc_solve_layout'),
    torch.float32: ('alloc_solve_f32', ctypes.c_float,
                    'alloc_solve_layout_f32')}


def alloc_layout(nb: int, k: int, method: str = 'alternating',
                 dtype: torch.dtype = torch.float64) -> dict:
    """How the card lays out a launch of ``nb`` problems of ``k``
    clients (``ALLOC_LAYOUT``) in ``dtype``: threads a block, lanes a
    client in a golden section, groups of lanes a block, blocks that hold
    the clients once (parts), blocks a problem (a cluster of replicas x
    parts), groups that take a dual price, bisection levels a round.
    Needs the card."""
    from repro_torch.core import allocation_jax as AJ
    AJ._check_method(method)
    name, _, entry = _ALLOC_KERNELS[dtype]
    out = (ctypes.c_int * len(ALLOC_LAYOUT))()
    err = getattr(build.library(name), entry)(ctypes.c_int(nb), ctypes.c_int(k),
             ctypes.c_int(AJ.METHODS.index(method)), out)
    if err:
        raise ValueError(f'alloc_solve_layout({nb}, {k}, {method!r}): '
                         f'CUDA error {err}')
    return dict(zip(ALLOC_LAYOUT, out))


def alloc_solve(prob, method: str = 'alternating', max_iters: int = 6,
                tol: float = 1e-5, n_grid: int = 256, newton_iters: int = 40,
                early_exit: bool = True, inner_tol: float = 0.0,
                gate: Optional[Tensor] = None,
                trips: Optional[Tensor] = None):
    """Solve eq. (28) for one problem or a batch
    (``core.allocation_jax.JaxAllocationProblem``) -> ``JaxAllocation``.

    On the card: one launch of the ``alloc_solve`` kernel (float64) or
    of its float32 instantiation ``alloc_solve_f32`` (a thread block or a
    cluster of blocks a problem, ``alloc_layout``); a problem of mixed
    dtypes raises.  No value is read back to the host, so a launch can
    be captured in a CUDA graph.
    ``gate`` (one value per problem, or one for all, on the card) solves
    a problem whose gate is not > 0 at the uniform point instead; with
    ``trips`` (int32 (B, len(ALLOC_TRIPS)) on the card) the kernel counts
    its work there (``ALLOC_TRIPS`` order).  On the CPU:
    ``allocation_jax.solve_plain``; ``trips`` is left as it is."""
    from repro_torch.core import allocation_jax as AJ
    AJ._check_method(method)
    fields = [getattr(prob, f) for f in AJ.PER_CLIENT + AJ.SCALARS]
    extra = [t for t in (prob.mask, gate) if t is not None]
    if not _on_card(*fields, *extra):
        return AJ.solve_plain(prob, method, max_iters, tol, n_grid,
                              newton_iters, early_exit, inner_tol, gate)
    dtype = fields[0].dtype
    if dtype not in _ALLOC_KERNELS or any(t.dtype != dtype
                                          for t in fields + extra):
        raise TypeError('alloc_solve takes a problem (and gate) all float64 '
                        'or all float32, got '
                        f'{sorted({str(t.dtype) for t in fields + extra})}')
    name, c_type, _ = _ALLOC_KERNELS[dtype]
    limits = alloc_limits()
    batched = AJ.is_batched(prob)
    nb, k = tuple(prob.A.shape) if batched else (1, prob.A.shape[0])
    if not 1 <= k <= limits['MAX_K']:
        raise ValueError(f'alloc_solve takes 1 to {limits["MAX_K"]} clients '
                         f'a problem, got {k}')
    if not 0 <= max_iters <= limits['MAX_ITERS']:
        raise ValueError(f'max_iters must be in [0, {limits["MAX_ITERS"]}], '
                         f'got {max_iters}')
    if n_grid < 2 or newton_iters < 0:
        raise ValueError('n_grid must be >= 2 and newton_iters >= 0')
    dev = prob.A.device

    def per_client(t):
        return t.reshape(nb, k).contiguous()

    # every tensor the kernel reads stays referenced until it is queued
    coef = torch.stack([per_client(getattr(prob, f)) for f in 'ABCD'],
                       dim=1).contiguous()
    gains, p_w = per_client(prob.gains), per_client(prob.p_w)
    mask = (per_client(prob.mask) if prob.mask is not None
            else torch.ones((nb, k), dtype=dtype, device=dev))
    scal = torch.stack([getattr(prob, f).reshape(nb) for f in AJ.SCALARS],
                       dim=1).contiguous()
    if gate is not None:
        gate = gate.reshape(-1).expand(nb).contiguous()
    if trips is not None:
        _expect(trips, 'trips', torch.int32, (nb, len(ALLOC_TRIPS)))
        _contig(trips, 'trips')
    caps = AJ._caps(dtype)
    # Python floats, rounded to the kernel's type as PyTorch rounds a
    # Python scalar against a tensor of that dtype
    consts = (c_type * 16)(
        caps.exp_cap, caps.pow_cap, caps.h_floor, caps.log_floor,
        caps.newton_eps, caps.a_eps, 1.0 - caps.a_eps, AJ.AC.BETA_MIN,
        AJ.AC.BETA_MAX, AJ.GOLDEN_RATIO, AJ.AC.LN2, AJ.LN10, tol, inner_tol,
        AJ.SCA_TOL, AJ.BARRIER_LR)
    real = dict(dtype=dtype, device=dev)
    scratch = torch.empty((nb, 3 * n_grid * k + 2 * k), **real)
    brackets = torch.empty((nb, (n_grid - 1) * k), dtype=torch.int32,
                           device=dev)
    alpha, beta, q, p = (torch.empty((nb, k), **real) for _ in range(4))
    objective = torch.empty((nb,), **real)
    objectives = torch.empty((nb, max_iters), **real)
    iters, reason = (torch.empty((nb,), dtype=torch.int32, device=dev)
                     for _ in range(2))

    def ptr(t):
        return None if t is None else t.data_ptr()

    _launch(name, coef, coef.data_ptr(), gains.data_ptr(),
            p_w.data_ptr(), mask.data_ptr(), scal.data_ptr(), ptr(gate),
            scratch.data_ptr(), brackets.data_ptr(), alpha.data_ptr(),
            beta.data_ptr(), q.data_ptr(), p.data_ptr(),
            objective.data_ptr(), iters.data_ptr(), objectives.data_ptr(),
            reason.data_ptr(), ptr(trips), ctypes.addressof(consts), nb, k,
            AJ.METHODS.index(method), max_iters, n_grid, newton_iters,
            int(early_exit))
    sol = AJ.JaxAllocation(alpha, beta, q, p, objective, iters, objectives,
                           reason)
    return sol if batched else AJ.JaxAllocation(*(x[0] for x in sol))
