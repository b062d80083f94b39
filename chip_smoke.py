#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. the card: ``nvidia-smi`` name and power limit, CUDA version;
2. build the ten hand-written CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel);
3. hold each kernel against its plain PyTorch version on the same card
   tensors, at the main path's shapes (K=20 clients, l=62,006 CNN
   parameters, 3 bits, the framed sign/modulus widths) and at a small
   ragged shape — every output bit-exact, the f32 sum also within the
   reference's FMA-wobble bound — and time both with CUDA events; then
   spfl_accumulate and fold_words, untimed, across the shapes their tiles,
   client chunks and clusters make edges (``check_edges``); then the whole
   packed, bit-level transport on the card against the same transport on
   the CPU at full width;
4. the main path: ``build_simulator(FLConfig(wire='packed',
   channel='bitlevel'))`` at full width (K=20, 500 images per client,
   2000 test images) for 5 rounds, with every kernel launch counter reset
   just before and read just after;
5. ``spfl_retx`` at -40 dBm with the uniform allocator for 3 rounds, where
   the bit channel really flips bits and sign packets are resent;
6. the per-client kernel API (``kernels.ops.*_flat``) on the main path's
   data — the K=20 gradients of phase 4's simulator — held bit for bit
   against the fused kernels of the main round, with the launch counters
   reset just before and read just after.

It prints one JSON line of per-kernel results, and as its last line
``{"ok": true, "device": {...}}``.  A kernel's ``launches`` is its count in
the run of its own path (``path``: 'round' is phase 4, 'api' phase 6),
with every counter reset just before that run.  Its ``bound_ms`` is the
larger of its bytes (each input read once, each output written once) over
the HBM rate and the operations its function needs (``FUNCTION_OPS``)
over the busiest pipe's rate; the SASS of the build on the same path is
printed beside it as a diagnostic.  It imports nothing of JAX and nothing
of the reference package ``repro``.  Kernel libraries are built under
``build/torch_kernels/``.
"""
from __future__ import annotations

import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / 'src'

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
# 132 SMs at the 1.98 GHz boost clock: the data sheet's 67 TFLOP/s float32
# is 132 SMs x 128 FP32 lanes x 2 flops x 1.98 GHz
N_SM, SM_CLOCK_HZ = 132, 1.98e9
K, BITS = 20, 3
# The operations each kernel's function needs per unit of work (the units
# of repro_torch.kernels.sass.MAIN_PATHS), by the Hopper pipe that does
# them (sass.PIPE_RATES): each arithmetic, logic, compare, select or
# conversion step of the math once, a division once, a three-input logic
# op once.  Address arithmetic, loads and stores, loop control and exit
# tests are costs of a build, not of the function, and are not counted;
# the SASS of the build is read beside it as a diagnostic.
FUNCTION_OPS = {
    # per coordinate: eq. (8) (|g|, - gmin, / step, floor, max, min,
    # - lower, <, +, max, min), g >= 0, the index to an integer, the sign
    # bit into its word; per coordinate and plane: shift, mask, or
    'quantize_pack': {'coordinate': {'fp32': 12, 'xu': 1, 'alu': 1},
                      'plane': {'alu': 3}},
    # per client and coordinate: the sign bit (shift, mask), the knob
    # (shift, mask, or per plane), float(q), q * step, + gmin, the mod_ok
    # and sign selects, s * m, w * (s * m), + acc, the gated vote bit (and,
    # shift, or); per coordinate: the vote popcount
    'spfl_accumulate': {'client': {'alu': 7 + 3 * BITS, 'fp32': 5, 'xu': 1},
                        'coordinate': {'xu': 1}},
    # per word: the PRF counter (k * W + col + word0), the plane-free mix
    # (+ golden, ^ seed0, fmix32, ^ seed1), the all-flip select, the xor
    # into the word, the fold xor, popcount and its add; per word and
    # each of its 32 bits: ^ the plane constant merged with fmix32's first
    # xor-shift (3), two xor-shifts (4), two multiplies, the threshold
    # compare and the bit set (2)
    'corrupt_fold': {'word': {'alu': 14 + 32 * 9, 'imad': 3 + 32 * 2,
                              'xu': 1}},
    'fold_words': {'word': {'alu': 1}},            # one xor
    # eq. (8) as above, g > 0 and g < 0, their difference, int(q)
    'quantize': {'coordinate': {'fp32': 13, 'alu': 1, 'xu': 1}},
    # float(q), float(s), q * step, + gmin, w * s, * m, the mod_ok select
    'dequant': {'coordinate': {'fp32': 4, 'alu': 1, 'xu': 2}},
    # eq. (8), the two sign compares, the decode's four products and sums,
    # the sign's two selects and the mod_ok select
    'roundtrip': {'coordinate': {'fp32': 17, 'alu': 3}},
    'pack_bits': {'plane': {'alu': 3}},            # shift, mask, or
    'unpack_bits': {'plane': {'alu': 3}},          # shift, mask, or
    # the sign bit (shift, mask), the sign and mod_ok selects, float(q),
    # q * step, + gmin, s * m, w * (s * m); per plane: shift, mask, or
    'unpack_dequant': {'coordinate': {'fp32': 4, 'alu': 4, 'xu': 1},
                       'plane': {'alu': 3}},
}


def kernels_on(path: str) -> list:
    """The kernels of ``path``: 'round' (the FL round) or 'api' (the
    per-client kernel API)."""
    from repro_torch.kernels import build
    return [name for name, kern in build.TABLE.items() if kern.path == path]


def fail(msg: str) -> int:
    print(f'FAIL: {msg}', file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, reps: int = 25, inner: int = 20) -> float:
    """Median device time of one ``fn()`` call: ``reps`` CUDA-event pairs
    around ``inner`` back-to-back calls each, queued behind a short device
    sleep so host launch overhead does not open gaps between them."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def launch_mix(per_unit: dict, units: dict) -> dict:
    """Operations by pipe of one launch that does ``units[u]`` units of
    work of each kind ``u``, at ``per_unit[u]`` (pipe -> count) each."""
    mix = {}
    for unit, count in units.items():
        for pipe, n in per_unit.get(unit, {}).items():
            mix[pipe] = mix.get(pipe, 0) + n * count
    return mix


def sass_unit_mixes(names) -> dict:
    """{kernel: {unit: SASS thread-instructions by pipe}} on each kernel's
    main path, read from its built library at the spans of
    ``sass.MAIN_PATHS``; a build whose fingerprint differs from the one the
    spans were read from gets no count (the bounds do not use it)."""
    from repro_torch.kernels import build, sass
    out = {}
    for name, lib in build.build(names).items():
        (instrs,) = sass.disassemble(lib).values()
        got = sass.fingerprint(instrs)
        if got != sass.MAIN_PATHS[name][0]:
            print(f'{name}: SASS fingerprint {got} differs from '
                  'MAIN_PATHS; read its spans anew', flush=True)
            continue
        out[name] = sass.main_path_mixes(name, instrs)
    return out


def fold_words_units(k: int, w: int) -> dict:
    """Units of work (``sass.MAIN_PATHS``) of one fold_words launch over
    (k, w) words: every thread, each thread's trips of the load loop
    (UNROLL words each), the threads and the handoff store of the blocks
    that are not their cluster's leader, the leader's threads and its
    first warp, and the words."""
    from repro_torch.kernels import build
    shape = build.constants('fold_words')
    cluster, threads = shape['CLUSTER'], shape['THREADS']
    per = -(-w // cluster)
    step = shape['UNROLL'] * threads
    trips = 0
    for rank in range(cluster):
        span = max(0, min(w, (rank + 1) * per) - min(w, rank * per))
        trips += sum(-(-(span - t) // step)
                     for t in range(min(span, threads)))
    followers = cluster - 1
    return dict(thread=k * cluster * threads, trip=k * trips,
                follower_thread=k * followers * threads,
                follower_store=k * followers, leader_thread=k * threads,
                leader_warp_thread=k * 32, word=k * w)


def spfl_accumulate_units(k: int, n: int, bits: int) -> dict:
    """Units of work (``sass.MAIN_PATHS``) of one spfl_accumulate launch:
    every thread of the tiles, the threads that copy sign words and those
    that copy knob words (a thread's words are of one kind when its
    block's thread count is a multiple of a client's words, as at the main
    shapes), the threads with a live coordinate and their clients, the
    coordinates and each client of each."""
    from repro_torch.kernels import build
    shape = build.constants('spfl_accumulate')
    tile, cpt = shape['TILE'], shape['CPT']
    threads = tile // cpt
    span = 32 // cpt
    tile_groups = tile // 32
    wpc = tile_groups * (1 + bits)
    blocks = -(-n // tile)
    sign = sum(1 for t in range(threads) if t % wpc < tile_groups)
    live = sum(min(span, n - 32 * g) for g in range(-(-n // 32)))
    return dict(thread=blocks * threads, sign_copier=blocks * sign,
                knob_copier=blocks * (threads - sign), live_thread=live,
                client_pair=live * k, coordinate=n, client=n * k)


def int_err(a, b) -> float:
    """Max |a - b| of two int32 word tensors read as uint32."""
    from repro_torch.wire.format import u64
    return float((u64(a) - u64(b)).abs().max()) if a.numel() else 0.0


def ulp_atol(weight, gmax, gbar) -> float:
    """The reference's FMA-wobble bound: 4 eps x sum_k w_k max(gmax_k,
    max gbar) (tests/test_packed_hotpath.py)."""
    import torch
    scale = float(torch.sum(weight * torch.clamp(gmax, min=float(gbar.max()))))
    return 4 * float(torch.finfo(torch.float32).eps) * max(scale, 1.0)


def check_kernels(k: int, n: int, timed: bool, seed: int):
    """Every kernel against its plain version at (k clients, n coords)."""
    import torch
    from repro_torch.core import bitchannel
    from repro_torch.core.quantize import knob_step
    from repro_torch.kernels import build, ops, ref
    from repro_torch.wire import corrupt as wire_corrupt
    from repro_torch.wire import format as fmt
    from repro_torch.wire import packets

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((k, n), generator=gen, device=dev) * 0.01
    g[:, :2] = 0.0
    rand = torch.rand((k, n), generator=gen, device=dev)
    a = g.abs()
    gmin, gmax = a.amin(1).contiguous(), a.amax(1).contiguous()
    results = {}

    # --- quantize_pack
    sw, qw = ops.quantize_pack_flat(g, rand, gmin, gmax, BITS)
    rsw, rqw = ref.quantize_pack(g, rand, gmin, gmax, BITS)
    err = max(int_err(sw, rsw), int_err(qw, rqw))
    if err:
        raise AssertionError(
            f'quantize_pack differs from plain at k={k} n={n}: '
            f'{int((sw != rsw).sum())} sign and {int((qw != rqw).sum())} '
            'knob words')
    groups = fmt.n_groups(n)
    results['quantize_pack'] = dict(
        max_abs_err=err,
        bytes=k * n * 8 + k * 8 + k * groups * (1 + BITS) * 4,
        units=dict(coordinate=k * n, plane=k * n * BITS))
    if timed:
        fn = build.kernel('quantize_pack')
        stream = torch.cuda.current_stream().cuda_stream
        args = (g.data_ptr(), rand.data_ptr(), gmin.data_ptr(),
                gmax.data_ptr(), sw.data_ptr(), qw.data_ptr(), k, n, BITS,
                stream)
        results['quantize_pack']['ms'] = device_ms(lambda: fn(*args))
        results['quantize_pack']['plain_ms'] = device_ms(
            lambda: ref.quantize_pack(g, rand, gmin, gmax, BITS), reps=20,
            inner=1)

    # --- framing, then the bit channel at a flipping operating point
    sign_words, mod_words = packets.frame_uplink_batch(
        sw, qw, gmin, gmax, n=n, bits=BITS, round_idx=3)
    q = torch.linspace(0.3, 1.0, k, device=dev)
    seeds = (0x1234ABCD + seed, 0xFEDCBA98)
    received = {}
    fold_err = 0.0
    for name, words, prob in (('sign', sign_words, q),
                              ('mod', mod_words, q.flip(0))):
        ber = bitchannel.ber_for_success(prob, words.shape[1])
        rx, fold, flips = ops.corrupt_fold_words(seeds, words, ber)
        thresh, allf = wire_corrupt.flip_threshold(ber)
        thresh = fmt.to_words(thresh).contiguous()
        allf = allf.to(torch.int32).contiguous()
        rrx, rfold, rflips = ref.corrupt_fold(seeds, words, thresh, allf)
        err = max(int_err(rx, rrx), int_err(fold, rfold),
                  float((flips - rflips).abs().max()))
        if err:
            raise AssertionError(f'corrupt_fold differs from plain ({name})')
        if int(flips.sum()) == 0:
            raise AssertionError('corrupt_fold check drew no flips')
        received[name] = rx
        folded = ops.fold_words(rx)
        fold_err = max(fold_err, int_err(folded, ref.fold_words(rx)))
        if fold_err:
            raise AssertionError(f'fold_words differs from plain ({name})')
        if name == 'mod':
            w = words.shape[1]
            results['corrupt_fold'] = dict(
                max_abs_err=err, bytes=2 * k * w * 4 + k * 16,
                units=dict(word=k * w))
            results['fold_words'] = dict(
                max_abs_err=fold_err, bytes=k * w * 4 + k * 4,
                units=fold_words_units(k, w))
            if timed:
                fn = build.kernel('corrupt_fold')
                stream = torch.cuda.current_stream().cuda_stream
                zf = torch.zeros(k, dtype=torch.int32, device=dev)
                zc = torch.zeros(k, dtype=torch.int32, device=dev)
                args = (words.data_ptr(), rx.data_ptr(), thresh.data_ptr(),
                        allf.data_ptr(), zf.data_ptr(), zc.data_ptr(), k, w,
                        seeds[0], seeds[1], 0, stream)
                results['corrupt_fold']['ms'] = device_ms(lambda: fn(*args))
                results['corrupt_fold']['plain_ms'] = device_ms(
                    lambda: ref.corrupt_fold(seeds, words, thresh, allf),
                    reps=20, inner=1)
                ffn = build.kernel('fold_words')
                fargs = (rx.data_ptr(), w, folded.data_ptr(), k, w, stream)
                results['fold_words']['ms'] = device_ms(lambda: ffn(*fargs))
                results['fold_words']['plain_ms'] = device_ms(
                    lambda: ref.fold_words(rx), reps=20, inner=1)

    # --- decode-once accumulation on the received (strided) payloads
    sign_ok = bitchannel.verify_sign_fold(received['sign'], n=n)
    mod_ok = bitchannel.verify_mod_fold(received['mod'], n=n, bits=BITS)
    weight = sign_ok.to(torch.float32) / q
    gbar = torch.rand((n,), generator=gen, device=dev) * 0.01
    rmin, rmax = packets.mod_header_ranges(received['mod'])
    sp = packets.sign_payload(received['sign'])
    mp = packets.mod_payload(received['mod'])
    acc, votes = ops.spfl_aggregate_packed(sp, mp, gbar, rmin, rmax, mod_ok,
                                           weight, sign_ok, n, BITS)
    step = knob_step(rmin, rmax, BITS)
    mok = mod_ok.to(torch.float32)
    gate = sign_ok.to(torch.int32)
    racc, rvotes = ref.spfl_accumulate(sp, mp, gbar, rmin, step, mok, weight,
                                       gate, n, BITS, True)
    err = float((acc - racc).abs().max())
    finite = torch.isfinite(racc)          # a damaged header may decode inf
    tol = ulp_atol(weight, torch.where(mod_ok, rmax, 0.0), gbar)
    if (not same_f32(acc, racc)
            or float((acc - racc)[finite].abs().max()) > tol
            or not torch.equal(votes, rvotes)):
        raise AssertionError(f'spfl_accumulate differs from plain: {err}')
    results['spfl_accumulate'] = dict(
        max_abs_err=float((acc - racc)[finite].abs().max()),
        bytes=k * groups * (1 + BITS) * 4 + n * 4 + k * 20 + n * 8,
        units=spfl_accumulate_units(k, n, BITS))
    if timed:
        fn = build.kernel('spfl_accumulate')
        stream = torch.cuda.current_stream().cuda_stream
        mokc, wc = mok.contiguous(), weight.contiguous()
        args = (sp.data_ptr(), sp.stride(0), mp.data_ptr(), mp.stride(0),
                gbar.data_ptr(), 0, rmin.data_ptr(), step.data_ptr(),
                mokc.data_ptr(), wc.data_ptr(), gate.data_ptr(),
                acc.data_ptr(), votes.data_ptr(), k, n, BITS, stream)
        results['spfl_accumulate']['ms'] = device_ms(lambda: fn(*args))
        results['spfl_accumulate']['plain_ms'] = device_ms(
            lambda: ref.spfl_accumulate(sp, mp, gbar, rmin, step, mok,
                                        weight, gate, n, BITS, True),
            reps=20, inner=1)
    return results


def same_f32(a, b) -> bool:
    """Element for element equal f32 tensors (-0 equals 0), NaN where
    the other is NaN."""
    import torch
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_edges(seed: int) -> int:
    """spfl_accumulate and fold_words, bit for bit against their plain
    versions, at the shapes their tiles, client chunks and clusters make
    edges: K one client, one chunk, one past it and past two chunks;
    bits 1, 3, 16 (the planes unrolled at their narrowest, main and
    widest width), 22-24 (rolled, the two stages just under, at and past
    the 48 KB of shared memory a block gets without opting in) and 32;
    n of one coordinate, around a group and around a tile and the main
    width; shared and per-client gbar; contiguous payload
    rows and rows framed as packets (strided, unaligned).  fold_words at
    K 1 and 20, W of 1, 7, one cluster's threads +-1 and the two packet
    widths, contiguous and strided.  -> the number of shapes checked."""
    import torch
    from repro_torch.core.quantize import knob_step
    from repro_torch.kernels import build, ops, ref
    from repro_torch.wire import format as fmt

    tile, chunk = (build.constants('spfl_accumulate')[c]
                   for c in ('TILE', 'CHUNK'))
    fold = build.constants('fold_words')
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             device=dev, dtype=torch.int32)

    def framed(rows, head):
        buf = words(rows.shape[0], head + rows.shape[1] + 1)
        buf[:, head:-1] = rows
        return buf[:, head:-1]

    shapes = 0
    for k in (1, chunk, chunk + 1, 2 * chunk + 1):
        gmin = torch.rand(k, generator=gen, device=dev) * 0.1
        gmax = 0.5 + torch.rand(k, generator=gen, device=dev) * 0.5
        mod_ok = torch.rand(k, generator=gen, device=dev) < 0.7
        weight = torch.rand(k, generator=gen, device=dev) * 2.0
        sign_ok = torch.rand(k, generator=gen, device=dev) < 0.8
        for bits in (1, 3, 16, 22, 23, 24, 32):
            step = knob_step(gmin, gmax, bits)
            for n in (1, 31, 33, tile - 1, tile + 1, 62006):
                groups = fmt.n_groups(n)
                sw, qw = words(k, groups), words(k, groups * bits)
                for gshape, layout in itertools.product(
                        ((n,), (k, n)), ('contiguous', 'framed')):
                    gbar = torch.rand(gshape, generator=gen, device=dev)
                    sp, mp = ((framed(sw, 4), framed(qw, 7))
                              if layout == 'framed' else (sw, qw))
                    acc, votes = ops.spfl_aggregate_packed(
                        sp, mp, gbar, gmin, gmax, mod_ok, weight, sign_ok,
                        n, bits)
                    racc, rvotes = ref.spfl_accumulate(
                        sp, mp, gbar, gmin, step, mod_ok.to(torch.float32),
                        weight, sign_ok.to(torch.int32), n, bits,
                        k <= ops.MAX_VOTE_CLIENTS)
                    at = (f'k={k} bits={bits} n={n} gbar {tuple(gshape)} '
                          f'{layout} rows')
                    if not same_f32(acc, racc):
                        raise AssertionError(
                            f'spfl_accumulate differs from plain at {at}: '
                            f'{int((acc != racc).sum())} coordinates')
                    if (votes is None) != (rvotes is None) or (
                            votes is not None
                            and not torch.equal(votes, rvotes)):
                        raise AssertionError(
                            f'spfl_accumulate votes differ at {at}')
                    if (votes is None) != (k > 32):
                        raise AssertionError(f'votes at {at}: {votes}')
                    shapes += 1
    for k in (1, K):
        for w in (1, 7, fold['CLUSTER'] * fold['THREADS'] - 1,
                  fold['CLUSTER'] * fold['THREADS'] + 1, 1943, 5822):
            rows = words(k, w)
            for layout, x in (('contiguous', rows),
                              ('strided', framed(rows, 3))):
                _exact(f'fold_words k={k} w={w} {layout} rows',
                       (ops.fold_words(x), ref.fold_words(x)))
                shapes += 1
    torch.cuda.synchronize()
    return shapes


def _exact(label: str, *pairs) -> float:
    """Raise unless every (kernel, plain) pair is equal element for
    element (f32 -0 equals 0); -> max |a - b| (uint32 for int32 words)."""
    import torch
    err = 0.0
    for a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f'{label}: kernel differs from plain '
                                 f'({a.shape} {a.dtype} vs {b.shape} '
                                 f'{b.dtype}, {int((a != b).sum())} values)')
        if a.numel():
            err = max(err, int_err(a, b) if a.dtype == torch.int32
                      else float((a.double() - b.double()).abs().max()))
    return err


def check_api_kernels(k: int, n: int, bits: int, timed: bool, seed: int):
    """The six kernels of the per-client API against their plain versions
    on k clients' flat (n,) vectors: coordinates 0 and 1 are g = 0 and
    g = -0, but client 1 (when k > 1) has a constant |g| (knob step 0); mod_ok
    alternates 1, 0 over the clients.  Also the packers at 32 bits on
    arbitrary words.  Client 0 is timed when ``timed``."""
    import torch
    from repro_torch.core.quantize import knob_step
    from repro_torch.kernels import build, ops, ref
    from repro_torch.wire import format as fmt

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((k, n), generator=gen, device=dev) * 0.01
    g[:, 0], g[:, 1] = 0.0, -0.0
    if k > 1:
        g[1] = -0.25
    rand = torch.rand((k, n), generator=gen, device=dev)
    gbar = torch.rand((n,), generator=gen, device=dev) * 0.01
    a = g.abs()
    gmin, gmax = a.amin(1), a.amax(1)
    mod_ok = (torch.arange(k, device=dev) % 2 == 0).to(torch.float32)
    weight = torch.linspace(0.5, 2.0, k, device=dev)
    err = dict.fromkeys(kernels_on('api'), 0.0)
    for i in range(k):
        at = f'k={k} n={n} bits={bits} client {i}'
        lo, hi, mok, w = (x[i:i + 1] for x in (gmin, gmax, mod_ok, weight))
        sign, qidx = ops.stochastic_quantize_flat(g[i], rand[i], lo, hi,
                                                  bits)
        rsign, rqidx = ref.quantize(g[i], rand[i], lo, hi, bits)
        err['quantize'] = max(err['quantize'], _exact(
            f'quantize {at}', (sign, rsign), (qidx, rqidx)))
        if bool((sign[:2][g[i, :2] == 0] != 0).any()):
            raise AssertionError(f'quantize {at}: g = +-0 gave sign '
                                 f'{sign[:2].tolist()}, not 0')
        out = ops.dequant_compensate_flat(sign, qidx, gbar, lo, hi, mok, w,
                                          bits)
        err['dequant'] = max(err['dequant'], _exact(
            f'dequant {at}', (out, ref.dequant(sign, qidx, gbar, lo, hi, mok,
                                               w, bits))))
        out = ops.spfl_roundtrip_flat(g[i], rand[i], gbar, lo, hi, mok, w,
                                      bits)
        err['roundtrip'] = max(err['roundtrip'], _exact(
            f'roundtrip {at}', (out, ref.roundtrip(g[i], rand[i], gbar, lo,
                                                   hi, mok, w, bits))))
        sbits = fmt.sign_to_bits(sign)
        sw = ops.pack_bits_flat(sbits, 1)
        qw = ops.pack_bits_flat(qidx, bits)
        err['pack_bits'] = max(err['pack_bits'], _exact(
            f'pack_bits {at}', (sw, ref.pack_bits(sbits, 1)),
            (qw, ref.pack_bits(qidx, bits))))
        back = ops.unpack_bits_flat(qw, n, bits)
        err['unpack_bits'] = max(err['unpack_bits'], _exact(
            f'unpack_bits {at}', (back, ref.unpack_bits(qw, n, bits)),
            (back, qidx)))
        step = knob_step(lo, hi, bits)
        out = ops.unpack_dequant_flat(sw, qw, gbar, lo, hi, mok, w, n, bits)
        err['unpack_dequant'] = max(err['unpack_dequant'], _exact(
            f'unpack_dequant {at}', (out, ref.unpack_dequant(
                sw, qw, gbar, lo, step, mok, w, n, bits))))
    words = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen,
                          device=dev, dtype=torch.int32)
    packed = ops.pack_bits_flat(words, 32)
    _exact(f'pack_bits n={n} bits=32', (packed, ref.pack_bits(words, 32)))
    _exact(f'unpack_bits n={n} bits=32',
           (ops.unpack_bits_flat(packed, n, 32), words))
    if not timed:
        return None

    groups = fmt.n_groups(n)
    planes = groups * bits * 4                      # knob word bytes
    results = {
        'quantize': dict(bytes=n * 8 + 8 + n * 5,
                         units=dict(coordinate=n)),
        'dequant': dict(bytes=n * 9 + 16 + n * 4,
                        units=dict(coordinate=n)),
        'roundtrip': dict(bytes=n * 12 + 16 + n * 4,
                          units=dict(coordinate=n)),
        'pack_bits': dict(bytes=n * 4 + planes,
                          units=dict(lane=groups * 32,
                                     plane=groups * 32 * bits,
                                     word=groups * bits)),
        'unpack_bits': dict(bytes=planes + n * 4,
                            units=dict(coordinate=n, plane=n * bits)),
        'unpack_dequant': dict(bytes=groups * 4 + planes + n * 4 + 16
                               + n * 4,
                               units=dict(coordinate=n, plane=n * bits)),
    }
    for name in results:
        results[name]['max_abs_err'] = err[name]
    # client 0 (mod_ok = 1), through the C entry points so that the timing
    # holds no wrapper overhead and no launch is counted
    lo, hi, mok, w = (x[0:1] for x in (gmin, gmax, mod_ok, weight))
    step = knob_step(lo, hi, bits)
    g0, r0 = g[0], rand[0]
    sign, qidx = ref.quantize(g0, r0, lo, hi, bits)
    sw = ref.pack_bits(fmt.sign_to_bits(sign), 1)
    qw = ref.pack_bits(qidx, bits)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    s8 = torch.empty((n,), dtype=torch.int8, device=dev)
    q32 = torch.empty((n,), dtype=torch.int32, device=dev)
    wout = torch.empty_like(qw)
    p = lambda t: t.data_ptr()
    launches = {
        'quantize': ((p(g0), p(r0), p(lo), p(hi), p(s8), p(q32), n, bits),
                     lambda: ref.quantize(g0, r0, lo, hi, bits)),
        'dequant': ((p(sign), p(qidx), p(gbar), p(lo), p(hi), p(mok), p(w),
                     p(out), n, bits),
                    lambda: ref.dequant(sign, qidx, gbar, lo, hi, mok, w,
                                        bits)),
        'roundtrip': ((p(g0), p(r0), p(gbar), p(lo), p(hi), p(mok), p(w),
                       p(out), n, bits),
                      lambda: ref.roundtrip(g0, r0, gbar, lo, hi, mok, w,
                                            bits)),
        'pack_bits': ((p(qidx), p(wout), n, bits),
                      lambda: ref.pack_bits(qidx, bits)),
        'unpack_bits': ((p(qw), p(q32), n, bits),
                        lambda: ref.unpack_bits(qw, n, bits)),
        'unpack_dequant': ((p(sw), p(qw), p(gbar), p(lo), p(step), p(mok),
                            p(w), p(out), n, bits),
                           lambda: ref.unpack_dequant(sw, qw, gbar, lo, step,
                                                      mok, w, n, bits)),
    }
    stream = torch.cuda.current_stream().cuda_stream
    for name, (args, plain) in launches.items():
        fn = build.kernel(name)
        results[name]['ms'] = device_ms(lambda: fn(*args, stream))
        results[name]['plain_ms'] = device_ms(plain, reps=20, inner=1)
    return results


def check_transport(k: int, n: int, seed: int) -> None:
    """The packed, bit-level transport (with one sign retransmission) on
    the card against the same transport on the CPU, same draws."""
    import torch
    from repro_torch.core import transport

    gen = torch.Generator().manual_seed(seed)
    grads = torch.randn((k, n), generator=gen) * 0.01
    gbar = torch.rand((n,), generator=gen) * 0.01
    q = torch.linspace(0.4, 1.0, k)
    p = torch.linspace(1.0, 0.4, k)
    draws = transport.make_draws(k, n, 1, 'bitlevel', torch.device('cpu'),
                                 gen, gen)
    out = {}
    for dev in ('cuda', 'cpu'):
        d = draws._replace(rand=draws.rand.to(dev))
        ghat, rec = transport.spfl_aggregate(
            grads.to(dev), gbar.to(dev), q.to(dev), p.to(dev), BITS, 64, d,
            n_retx=1, wire='packed', round_idx=7, channel='bitlevel')
        out[dev] = (ghat.cpu(), rec.to_host())
    (g_gpu, r_gpu), (g_cpu, r_cpu) = out['cuda'], out['cpu']
    for name in ('sign_ok', 'mod_ok', 'sign_flips', 'mod_flips',
                 'sign_crc_ok', 'retx_attempts', 'sign_votes',
                 'payload_bits'):
        if not (getattr(r_gpu, name) == getattr(r_cpu, name)).all():
            raise AssertionError(f'transport {name}: card != CPU')
    tol = ulp_atol(torch.ones(k) / q, grads.abs().amax(1), gbar) / k
    if float((g_gpu - g_cpu).abs().max()) > tol:
        raise AssertionError('transport ghat: card != CPU')
    if int(r_gpu.sign_flips.sum()) == 0:
        raise AssertionError('transport check drew no flips')


def run_sim(fl, rounds: int, label: str):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.training.fl_loop import build_simulator

    t0 = time.perf_counter()
    sim = build_simulator(fl, per_device=500, n_test=2000)
    print(f'{label}: set-up {time.perf_counter() - t0:.3f} s '
          f'(K={sim.K}, l={sim.dim})', flush=True)
    ops.reset_launch_counts()
    hist = sim.run(rounds)
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    for n in range(rounds):
        print(f'{label} round {n}: {hist.round_time_s[n] * 1e3:.3f} ms '
              f'(host eq. (28) {hist.alloc_time_s[n] * 1e3:.3f} ms) '
              f'loss {hist.loss[n]:.6f} acc {hist.test_acc[n]:.4f} '
              f'payload_bits {hist.payload_bits[n]:.0f}', flush=True)
    print(f'{label} launches: {json.dumps(counts)}', flush=True)
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f'{label}: non-finite loss {hist.loss}')
    missing = [name for name in kernels_on('round') if counts[name] <= 0]
    if missing:
        raise AssertionError(f'{label}: kernels never launched: {missing}')
    return sim, hist, counts


def run_kernel_api(sim) -> dict:
    """Phase 6: the per-client kernel API on the main path's data.  The
    K client gradients of ``sim`` at its parameters, per-client ranges
    min/max |g|, the simulator's gbar, seeded uniforms, mod_ok alternating
    1, 0 and a linspace of weights; per client k, bit for bit:

    (a) pack_bits(qidx) equals the knob words of quantize_pack;
    (b) pack_bits(sign_to_bits(sign), 1) equals its sign words;
    (c) unpack_bits(pack_bits(qidx)) equals qidx;
    (d) roundtrip equals dequant(quantize());
    (e) the f32 sum k = 0..K-1 of unpack_dequant on each client's
        quantize_pack words equals spfl_aggregate_packed's sum.

    -> the launch counts of the phase (reset just before)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.wire import format as fmt

    _, grads = sim.client_grads(sim.params)
    grads = grads.detach().contiguous()
    k, n = grads.shape
    dev = grads.device
    a = grads.abs()
    gmin, gmax = a.amin(1), a.amax(1)
    gbar = sim.gbar
    gen = torch.Generator(device=dev).manual_seed(6)
    rand = torch.rand((k, n), generator=gen, device=dev)
    mod_ok = (torch.arange(k, device=dev) % 2 == 0).to(torch.float32)
    weight = torch.linspace(0.5, 2.0, k, device=dev)
    ops.reset_launch_counts()
    sw, qw = ops.quantize_pack_flat(grads, rand, gmin, gmax, BITS)
    failed = []
    acc = None
    for i in range(k):
        args = (gmin[i], gmax[i], mod_ok[i], weight[i])
        sign, qidx = ops.stochastic_quantize_flat(grads[i], rand[i],
                                                  gmin[i], gmax[i], BITS)
        words = ops.pack_bits_flat(qidx, BITS)
        checks = {
            'a': torch.equal(words, qw[i]),
            'b': torch.equal(ops.pack_bits_flat(fmt.sign_to_bits(sign), 1),
                             sw[i]),
            'c': torch.equal(ops.unpack_bits_flat(words, n, BITS), qidx),
            'd': torch.equal(
                ops.spfl_roundtrip_flat(grads[i], rand[i], gbar, *args,
                                        BITS),
                ops.dequant_compensate_flat(sign, qidx, gbar, *args, BITS)),
        }
        failed += [f'({c}) client {i}' for c, ok in checks.items() if not ok]
        contrib = ops.unpack_dequant_flat(sw[i], qw[i], gbar, *args, n, BITS)
        acc = contrib if i == 0 else acc + contrib
    agg, _ = ops.spfl_aggregate_packed(
        sw, qw, gbar, gmin, gmax, mod_ok, weight,
        torch.ones(k, dtype=torch.bool, device=dev), n, BITS)
    if not torch.equal(acc, agg):
        failed.append(f'(e) {int((acc != agg).sum())} of {n} coordinates')
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    print(f'kernel API (K={k}, l={n}): launches {json.dumps(counts)}',
          flush=True)
    if failed:
        raise AssertionError(f'kernel API identities fail: {failed}')
    if not bool(torch.isfinite(acc).all()):
        raise AssertionError('kernel API: non-finite client sum')
    short = [name for name in kernels_on('api') if counts[name] < k]
    if short:
        raise AssertionError(f'kernel API: launched fewer than K={k} '
                             f'times: {short}')
    print(f'kernel API: identities (a)-(e) hold bit for bit for all {k} '
          'clients', flush=True)
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail('torch is not installed')
    if not torch.cuda.is_available():
        return fail('no CUDA card: this script runs the port on the card')
    if not (SRC / 'repro_torch' / 'kernels' / 'csrc').is_dir():
        return fail(f'{SRC / "repro_torch"} not found: run from a checkout')
    sys.path.insert(0, str(SRC))

    # 1. the card
    card = card_line()
    print(card, flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)} '
          f'count {torch.cuda.device_count()}', flush=True)

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    print(f'build: {time.perf_counter() - t0:.3f} s -> {build.BUILD_DIR}',
          flush=True)

    # 3. kernels against their plain versions
    l_main = 62006
    results = check_kernels(K, l_main, timed=True, seed=1)
    check_kernels(3, 1007, timed=False, seed=2)
    print(f'edge sweep: spfl_accumulate and fold_words bit-exact at '
          f'{check_edges(seed=11)} shapes', flush=True)
    results.update(check_api_kernels(2, l_main, BITS, timed=True, seed=5))
    for bits in (1, BITS, 16):
        check_api_kernels(3, 1007, bits, timed=False, seed=6 + bits)
    check_transport(K, l_main, seed=3)
    check_transport(3, 1007, seed=4)
    print('kernels and transport agree with their plain versions', flush=True)

    from repro_torch.configs.base import FLConfig
    from repro_torch.wire import format as fmt

    # 4. the main path at full width
    fl = FLConfig(wire='packed', channel='bitlevel')
    sim, hist, counts = run_sim(fl, 5, 'main')
    want = fmt.measured_uplink_bits(sim.dim, fl.quant_bits, sim.K)
    if any(b != want for b in hist.payload_bits):
        raise AssertionError(f'payload_bits {hist.payload_bits} != '
                             f'measured frames {want}')
    # 5. the operating point where the bit channel flips and resends
    fl5 = FLConfig(wire='packed', channel='bitlevel',
                   transport='spfl_retx', allocator='uniform',
                   tx_power_dbm=-40.0)
    sim5, hist5, _ = run_sim(fl5, 3, 'retx')
    flips = sum(int(r.sign_flips.sum() + r.mod_flips.sum())
                for r in sim5.records)
    crc_fail = sum(int((~r.sign_crc_ok).sum() + (~r.mod_crc_ok).sum())
                   for r in sim5.records)
    print(f'retx: flips {flips}, first-attempt CRC failures {crc_fail}, '
          f'resends {hist5.retransmissions}', flush=True)
    if flips <= 0 or crc_fail <= 0:
        raise AssertionError('the low-power run drew no flips or no '
                             'CRC failures')
    # 6. the per-client kernel API on the main path's data
    api_counts = run_kernel_api(sim)

    leaked = sorted(m for m in sys.modules
                    if m == 'jax' or m.startswith(('jax.', 'repro.'))
                    or m == 'repro')
    if leaked:
        return fail(f'imported {leaked}')

    from repro_torch.kernels import sass
    sass_mixes = sass_unit_mixes(build.KERNELS)
    launches = {'round': counts, 'api': api_counts}
    rows = []
    for name, kern in build.TABLE.items():
        r = results[name]
        bytes_ms = r['bytes'] / HBM_BYTES_PER_S * 1e3
        ops = launch_mix(FUNCTION_OPS[name], r['units'])
        clocks = sass.resource_clocks(ops)
        ops_ms = max(clocks.values()) / (N_SM * SM_CLOCK_HZ) * 1e3
        line = (f'{name}: {r["bytes"]} B -> {bytes_ms:.7f} ms; function '
                f'{json.dumps(ops, sort_keys=True)} operations -> '
                f'{ops_ms:.7f} ms ({max(clocks, key=clocks.get)}-bound)')
        if name in sass_mixes:
            mix = launch_mix(sass_mixes[name], r['units'])
            line += (f'; SASS {json.dumps(mix, sort_keys=True)} '
                     f'thread-instructions, {sum(mix.values())} = '
                     f'{sum(mix.values()) / sum(ops.values()):.2f} x the '
                     'function')
        print(line, flush=True)
        rows.append({
            'name': name, 'route': 'cuda', 'source': build.repo_source(name),
            'replaces': kern.replaces, 'launches': launches[kern.path][name],
            'path': kern.path, 'max_abs_err': r['max_abs_err'],
            'ms': r['ms'], 'plain_ms': r['plain_ms'],
            'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'library_ms': None})
    print(card, flush=True)
    print(json.dumps({'kernels': rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
