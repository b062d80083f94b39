#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. the card: ``nvidia-smi`` name and power limit, CUDA version;
2. build the four hand-written CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel);
3. hold each kernel against its plain PyTorch version on the same card
   tensors, at the main path's shapes (K=20 clients, l=62,006 CNN
   parameters, 3 bits, the framed sign/modulus widths) and at a small
   ragged shape — integers bit-exact, the f32 sum within the reference's
   FMA-wobble bound — and time both with CUDA events; then the whole
   packed, bit-level transport on the card against the same transport on
   the CPU at full width;
4. the main path: ``build_simulator(FLConfig(wire='packed',
   channel='bitlevel'))`` at full width (K=20, 500 images per client,
   2000 test images) for 5 rounds, with every kernel launch counter reset
   just before and read just after;
5. ``spfl_retx`` at -40 dBm with the uniform allocator for 3 rounds, where
   the bit channel really flips bits and sign packets are resent.

It prints one JSON line of per-kernel results, and as its last line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX and nothing
of the reference package ``repro``.  Kernel libraries are built under
``build/torch_kernels/``.
"""
from __future__ import annotations

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
# Each kernel's main path per unit of work, in thread-instructions by
# execution pipe, as `python -m repro_torch.kernels.sass --paths` counts
# them in the SASS of the nvcc 12.9 sm_90a build (the spans are
# repro_torch.kernels.sass.MAIN_PATHS; recount them when a kernel changes).
# sass.bound_clocks turns a mix into the least clocks an SM needs for it.
UNIT_MIX = {
    'quantize_pack': {
        'coordinate': {'alu': 45, 'fp32': 14, 'imad': 33, 'other': 58,
                       'xu': 8},
        'plane': {'alu': 4, 'other': 6}},
    'spfl_accumulate': {
        'coordinate': {'alu': 16, 'imad': 12, 'other': 20, 'xu': 1},
        'client': {'alu': 37, 'fp32': 5, 'imad': 28, 'other': 41, 'xu': 1}},
    'corrupt_fold': {
        'word': {'alu': 331, 'imad': 83, 'other': 31, 'shfl': 10, 'xu': 1}},
    'fold_words': {
        'thread': {'alu': 10, 'imad': 4, 'other': 16, 'shfl': 5},
        'word': {'alu': 5, 'imad': 4, 'other': 2},
        'warp0_thread': {'alu': 7, 'imad': 4, 'other': 11, 'shfl': 5}},
}
FOLD_WORDS_THREADS = 512          # fold_words.cu: one block per client row

K, BITS = 20, 3
MAIN_KERNEL_SOURCES = {
    'quantize_pack': ('src/repro_torch/kernels/csrc/quantize_pack.cu',
                      'src/repro/wire/pack_kernel.py:133'),
    'spfl_accumulate': ('src/repro_torch/kernels/csrc/spfl_accumulate.cu',
                        'src/repro/wire/pack_kernel.py:169'),
    'corrupt_fold': ('src/repro_torch/kernels/csrc/corrupt_fold.cu',
                     'src/repro/wire/pack_kernel.py:220'),
    'fold_words': ('src/repro_torch/kernels/csrc/fold_words.cu',
                   'src/repro/wire/pack_kernel.py:263'),
}


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


def launch_mix(name: str, **units: int) -> dict:
    """Thread-instructions by pipe of one launch of kernel ``name`` that
    does ``units[u]`` units of work of each kind ``u``."""
    mix = {}
    for unit, count in units.items():
        for pipe, n in UNIT_MIX[name][unit].items():
            mix[pipe] = mix.get(pipe, 0) + n * count
    return mix


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
        mix=launch_mix('quantize_pack', coordinate=k * n,
                       plane=k * n * BITS))
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
                mix=launch_mix('corrupt_fold', word=k * w))
            results['fold_words'] = dict(
                max_abs_err=fold_err, bytes=k * w * 4 + k * 4,
                mix=launch_mix('fold_words',
                               thread=k * min(FOLD_WORDS_THREADS, w),
                               word=k * w, warp0_thread=k * 32))
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
    if (not torch.equal(finite, torch.isfinite(acc))
            or float((acc - racc)[finite].abs().max()) > tol
            or not torch.equal(votes, rvotes)):
        raise AssertionError(f'spfl_accumulate differs from plain: {err}')
    results['spfl_accumulate'] = dict(
        max_abs_err=float((acc - racc)[finite].abs().max()),
        bytes=k * groups * (1 + BITS) * 4 + n * 4 + k * 20 + n * 8,
        mix=launch_mix('spfl_accumulate', coordinate=n, client=n * k))
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
    missing = [name for name, c in counts.items() if c <= 0]
    if missing:
        raise AssertionError(f'{label}: kernels never launched: {missing}')
    return sim, hist, counts


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

    leaked = sorted(m for m in sys.modules
                    if m == 'jax' or m.startswith(('jax.', 'repro.'))
                    or m == 'repro')
    if leaked:
        return fail(f'imported {leaked}')

    from repro_torch.kernels import sass
    rows = []
    for name, (src, replaces) in MAIN_KERNEL_SOURCES.items():
        r = results[name]
        bytes_ms = r['bytes'] / HBM_BYTES_PER_S * 1e3
        clocks = sass.resource_clocks(r['mix'])
        ops_ms = max(clocks.values()) / (N_SM * SM_CLOCK_HZ) * 1e3
        print(f'{name}: {r["bytes"]} B -> {bytes_ms:.7f} ms; '
              f'{json.dumps(r["mix"], sort_keys=True)} thread-instructions '
              f'-> {ops_ms:.7f} ms ({max(clocks, key=clocks.get)}-bound)',
              flush=True)
        rows.append({
            'name': name, 'route': 'cuda', 'source': src,
            'replaces': replaces, 'launches': counts[name],
            'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': max(bytes_ms, ops_ms),
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
