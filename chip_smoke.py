#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. the card: ``nvidia-smi`` name and power limit, CUDA version;
2. build the twelve hand-written CUDA kernels from the eleven sources of
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel; the solver's float64 and float32 instantiations share one),
   and print what ptxas reports for the solver kernel's two functions
   (registers, stack, spills), which must not spill (``check_spills``);
3. hold each kernel against its plain PyTorch version on the same card
   tensors, at the main path's shapes (K=20 clients, l=62,006 CNN
   parameters, 3 bits, the framed sign/modulus widths) and at a small
   ragged shape — every output bit-exact, the f32 sum also within the
   reference's FMA-wobble bound — and time both with CUDA events (a
   kernel from device memory, ``kernel_ms``, and warm; pack_bits at bits
   1, dequant, roundtrip and unpack_dequant at mod_ok 0 too); then the
   four round kernels and the six API kernels, untimed, across the
   shapes their tiles, client chunks, clusters, warps, vectors and blocks
   make edges and on unaligned rows (``check_edges``); then that a
   ``corrupt_fold_words`` call writes every output (stale memory in
   between; calls on two streams at once) and launches one kernel and no
   fill, and that an ``unpack_bits_flat`` or ``unpack_dequant_flat``
   call is one device operation, its kernel
   (``check_unpack_launches``); that the kernels launched with
   programmatic dependent launch wait before any global load or store
   (their SASS) and agree with their plain versions when the kernel
   before writes their input or reads their output, and on two streams
   (``check_pdl_hazards``); then
   the whole packed, bit-level transport on the card against the same
   transport on the CPU at full width; then the eq. (28) solver kernel
   (``alloc_solve``) against its plain version on the card, one batched
   call per method on the CPU tests' parity grid plus a K=20 problem,
   within the engine-parity contract (bit for bit is the aim; the script
   says which outputs differ if any), and the batch against each problem
   alone and unpadded, bit for bit (``check_alloc_kernel``); then the
   solver at K on every edge of its layout (lanes, groups, blocks a
   problem, cluster), each alone against one plain solve of all of them,
   bit for bit, with and without the tolerance exits, batches of 20 and
   140 problems (smaller clusters, then none) against each problem
   alone, and the barrier method at K=257 (two blocks a problem) against
   its plain solve (``check_alloc_layouts``);
4. the main path: ``build_simulator(FLConfig(wire='packed',
   channel='bitlevel'))`` at full width (K=20, 500 images per client,
   2000 test images) for 5 rounds, with every kernel launch counter reset
   just before and read just after; then the device operations of one
   more round under ``torch.profiler``; the solver kernel on that run's
   own host problems against the host solutions
   (``check_host_problems``); the same main path with
   ``allocation_backend='jax'`` for 5 rounds (counters reset, the solver
   launched once a round), both backends' round times, each round's
   solve again alone with its kernel time, effort, trip counts (the
   sequential function's, and the speculative sections apart) and the
   solver's layout (``time_device_solves``), that nothing from a round's gradients to
   its (q, p) waits for the card (``check_no_sync``), and one more round
   under ``torch.profiler`` split into gradients, stats, solve,
   transport, update and evaluation (``round_split``);
5. ``spfl_retx`` at -40 dBm with the uniform allocator for 3 rounds, where
   the bit channel really flips bits and sign packets are resent;
6. the per-client kernel API (``kernels.ops.*_flat``) on the main path's
   data — the K=20 gradients of phase 4's simulator — held bit for bit
   against the fused kernels of the main round, with the launch counters
   reset just before and read just after;
7. per-round fading cadence and the paper's baselines
   (``run_fading_and_baselines``), each run with the counters reset just
   before and read just after: ``build_simulator(FLConfig(wire='packed',
   channel='bitlevel', allocation_backend='jax',
   allocation_cadence='per_round'))`` for 5 rounds (``alloc_solve`` once
   a round on that round's row of the fading trajectory, the four round
   kernels 5, 5, 10 and 10 times, rows that differ, ``check_no_sync`` on
   a trajectory row, each solve timed alone with its trips and whether
   its dual searches kept to the spine, and rounds 1 and 4's problems
   solved by the host solver and the kernel within the contract,
   ``check_host_problems``); the same with the 'numpy' backend for 2
   rounds (2 host solves); dds, onebit and scheduling for 3 rounds each
   on the bit channel's calibration and on Bernoulli draws (analytic
   wire: no kernel); dds and scheduling again at -45 dBm on both
   channels, where packets are lost, one such round held against the CPU
   (``check_baseline_round``); error_free on the packed wire for 3 rounds
   (quantize_pack and spfl_accumulate 3 times each, nothing else), and
   one error_free round held against its plain versions on the CPU
   (``check_error_free_round``: words bit for bit, the aggregate within
   the FMA-wobble bound);
8. byzantine clients, stragglers and packed-domain screening
   (``run_adversary``), each run ``FLConfig(wire='packed',
   channel='bitlevel', allocation_backend='jax', ...)`` with the counters
   reset just before and read just after: signflip and scaled with
   ``screen=True`` (3 rounds each, an honest run's launches, the
   suspects per round, one round on the card against the CPU bit for
   bit: ``check_adversary_round``), dropout 0.25 (5 rounds; a dropped
   row is a no-op on the card), a benign screen (3 rounds; bit for bit
   the unscreened round), labelflip (2 rounds; the flipped rows are the
   mask's), and the cost of screening under ``torch.profiler``
   (``screen_cost``: the ``round/screen`` span and the device operations
   it adds);
9. population cohorts and the telemetry ring (``run_population``), each
   run ``FLConfig(wire='packed', channel='bitlevel',
   allocation_backend='jax', population_n=..., cohort_size=20,
   population_shards=64)`` at full width (``POP_RUNS``) with the
   counters reset just before and read just after: pop-uniform (N =
   10^6, uniform sampler, per-round shadowing, ``telemetry_path`` set; 5
   rounds, rounds 0-2 the pinned ``POP_UNIFORM_IDS``), pop-availability
   (N = 10^6; 3 rounds) and pop-ragged (N = K = 20, absent rows; 3
   rounds): main-jax's launches exactly, distinct ids in [0, N),
   ``participation_frac``, each solve timed alone with its trips and
   spine status, one round on the card against the CPU bit for bit
   (``check_population_round``), the ``round/cohort`` span under
   ``torch.profiler`` (``round_split``); for pop-uniform the JSONL
   against the history (``check_telemetry``) and the cohort draw through
   (q, p) and a ring push under sync debug mode 'error'
   (``check_population_no_sync``);
10. fused rounds (``run_fused``): the float32 solver kernel
   (``alloc_solve_f32``) against its plain version bit for bit and
   against the float64 kernel within the f32 contract
   (``check_alloc_f32``); main-jax with ``telemetry_flush_every=4`` for
   10 rounds (two segments of 4 and a ragged tail of 2) under
   ``round_fusion`` 'eager' (one captured round, replayed once a round)
   and 'scan' (a segment's rounds in one CUDA graph) and in the host
   loop, each with the counters reset just before and read just after;
   the fused runs go under ``torch.profiler``, whose records give the
   kernels the card ran, the graphs' replays included (every kernel's
   exact count: the rounds plus the warm-up round), while the wrappers'
   counters show what the warm-up and the captures issued; 'scan' =
   'eager' bit for bit
   (parameters, ḡ, every record field); the host loop handed the fused
   round's float32 solve with deterministic cuDNN = 'scan' bit for bit,
   each of its solves timed alone with its trips; whether repeated
   gradient passes give the same bits under cuDNN's default and its
   deterministic algorithms; the host loop with deterministic cuDNN
   (its round times); the round times of a second run of each
   dispatch (graphs kept: every segment steady); error_free fused = the
   host loop's bit for bit; pop-uniform fused for 3 rounds (the pinned
   cohorts); signflip + screen in the host loop and fused (8 rounds each,
   the round times); every other knob of the host loop fused for 3
   rounds (``FUSED_SWEEP``: retx, the Bernoulli channel, the analytic
   wire, each compensation, per-round fading, the barrier allocator,
   scaled + screen, dropout with a participation floor and the JSONL
   sink, labelflip, the baselines); a whole 'scan' segment and an 'eager' replay under sync
   debug mode 'error' (``Watch``); the device operations of one
   replayed round beside the host loop's round, and one segment's idle
   share under ``torch.profiler``; the last round's f32 solve held to
   its plain version bit for bit (its row in the JSON line, ``launches``
   the profiler's count of the 'scan' run).

It prints one JSON line of per-kernel results, and as its last line
``{"ok": true, "device": {...}}``.  A kernel's ``launches`` is its count in
the run of its own path (``path``: 'round' is phase 4's main run, 'alloc'
its ``allocation_backend='jax'`` run, 'api' phase 6), with every counter
reset just before that run; ``alloc_solve_f32``'s is the count of its
kernel in the card's record of phase 10's 'scan' run (``torch.profiler``:
the wrappers do not see a graph's replays).  The solver's row times the last main-jax (float32: fused)
round's solve (``ms`` and ``warm_ms`` are the same measurement: its
inputs are a few hundred bytes) and its plain version once; its bound
counts the work of that solve's trip counts.  Its ``bound_ms`` is the
larger of its bytes (each input read once, each output written once) over
the HBM rate and the operations its function needs (``FUNCTION_OPS``)
over the busiest pipe's rate, each shift and bit set placed on the ALU
or IMAD pipe where the busier of the two is least loaded; the SASS of
the build on the same path is printed beside it as a diagnostic.  Its
``ms`` is timed from device memory (``kernel_ms``), ``warm_ms`` on one
set of tensors; the rows of pack_bits, dequant, roundtrip and
unpack_dequant add ``variants``, the same for their other phase 6 calls
(bits 1, mod_ok 0).  It imports
nothing of JAX and nothing of the reference package ``repro``.  Kernel libraries are built under
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
L2_BYTES = 50 * 2 ** 20         # H100 L2 cache
K, BITS = 20, 3
# The operations each kernel's function needs per unit of work (the units
# of repro_torch.kernels.sass.MAIN_PATHS), by the Hopper pipe that does
# them (sass.PIPE_RATES): each arithmetic, logic, compare, select or
# conversion step of the math once, a division once, a three-input logic
# op once.  A shift ('shift') and a bit set into a clear bit of a word
# ('bitset': an or of a lone bit, or 2 w + bit) may issue on the ALU or
# as an IMAD (sass.FLEXIBLE): the bound places each kernel's shifts and
# bit sets where the busiest pipe is least loaded.  Address arithmetic,
# loads and stores, loop control and exit tests are costs of a build, not
# of the function, and are not counted; the SASS of the build is read
# beside it as a diagnostic.
FUNCTION_OPS = {
    # per coordinate: eq. (8) (|g|, - gmin, / step, floor, max, min,
    # - lower, <, +, max, min), g >= 0, the index to an integer, the sign
    # bit into its word; per coordinate and plane: shift, mask, the bit
    # set
    'quantize_pack': {'coordinate': {'fp32': 12, 'xu': 1, 'alu': 1},
                      'plane': {'alu': 1, 'shift': 1, 'bitset': 1}},
    # per client and coordinate: the sign bit (shift, mask), the knob
    # (shift, mask, bit set per plane), float(q), q * step, + gmin, the
    # mod_ok and sign selects, s * m, w * (s * m), + acc, the gated vote
    # bit (and, shift, bit set); per coordinate: the vote popcount
    'spfl_accumulate': {'client': {'alu': 4 + BITS, 'shift': 2 + BITS,
                                   'bitset': 1 + BITS, 'fp32': 5, 'xu': 1},
                        'coordinate': {'xu': 1}},
    # per word: the PRF counter (k * W + col + word0), the plane-free mix
    # (+ golden, ^ seed0, fmix32's three xor-shifts and two multiplies,
    # ^ seed1), A = h0 ^ h0 >> 16, the all-flip select, the xor into the
    # word, the fold xor, popcount and its add; per word and each of its 32
    # bits: A ^ the plane's constant (fmix32's first xor-shift, by the
    # identity (h0 ^ c) ^ (h0 ^ c) >> 16 = A ^ (c ^ c >> 16)), two
    # xor-shifts, two multiplies, the threshold compare and the bit set
    'corrupt_fold': {'word': {'alu': 12 + 32 * 4, 'shift': 4 + 32 * 2,
                              'bitset': 32, 'imad': 3 + 32 * 2, 'xu': 1}},
    'fold_words': {'word': {'alu': 1}},            # one xor
    # eq. (8) as above, g > 0 and g < 0, their difference, int(q)
    'quantize': {'coordinate': {'fp32': 13, 'alu': 1, 'xu': 1}},
    # float(q), float(s), q * step, + gmin, w * s, * m, the mod_ok select
    'dequant': {'coordinate': {'fp32': 4, 'alu': 1, 'xu': 2}},
    # eq. (8), the two sign compares, the decode's four products and sums,
    # the sign's two selects and the mod_ok select
    'roundtrip': {'coordinate': {'fp32': 17, 'alu': 3}},
    # shift, mask, bit set
    'pack_bits': {'plane': {'alu': 1, 'shift': 1, 'bitset': 1}},
    'unpack_bits': {'plane': {'alu': 1, 'shift': 1, 'bitset': 1}},
    # the sign bit (shift, mask), the sign and mod_ok selects, float(q),
    # q * step, + gmin, s * m, w * (s * m); per plane: shift, mask, bit
    # set
    'unpack_dequant': {'coordinate': {'fp32': 4, 'alu': 3, 'shift': 1,
                                      'xu': 1},
                       'plane': {'alu': 1, 'shift': 1, 'bitset': 1}},
    # float64 (the eq. (28) solver), per client and unit of the work the
    # kernel's trip counts record (alloc_units): an add, multiply,
    # divide, min, max, exp, pow or sqrt is one fp64 operation (each
    # divide, exp and pow is a sequence of DFMA on the card, so this is a
    # lower bound), a compare or select one alu.  H(beta) and H'(beta)
    # are 10 each, the four exponents of eq. (27) 10 (+2 selects), G 25,
    # G' 38.  grid_point: G' and the grid point, the sign test and the
    # argmin's compare; newton_step: G' twice, the slope, the Newton
    # point and the midpoint, the bracket's tests and selects; bracket:
    # its midpoint and G at the root; alpha_client: H_s, H_v and G at
    # alpha_max; golden_pair: two surrogate evaluations (two H, the
    # linearizations, four terms of 8, their sum, + lam beta: 63 each)
    # and the bracket update; golden_call: the start, the midpoint and
    # the sum's add; sca_round: the surrogate's set-up (H, H' of both
    # packets, four exponents and bases); objective: two H, G, the sum;
    # barrier_step: the slack's sum, dG/dbeta (two H, two H', four
    # terms of 15), the barrier terms, the norm's square and add, the
    # step and the stall test; backtrack: the new point and the sum.
    'alloc_solve': {
        'grid_point': {'fp64': 40, 'alu': 4},
        'newton_step': {'fp64': 83, 'alu': 12},
        'bracket': {'fp64': 27, 'alu': 3},
        'alpha_client': {'fp64': 45, 'alu': 2},
        'golden_pair': {'fp64': 130, 'alu': 11},
        'golden_call': {'fp64': 8},
        'sca_round': {'fp64': 75, 'alu': 4},
        'objective': {'fp64': 47, 'alu': 2},
        'barrier_step': {'fp64': 116, 'alu': 3},
        'backtrack': {'fp64': 4, 'alu': 2},
    },
}
# its float32 instantiation (the fused rounds' in-round solve): the same
# operations on the float32 pipe
FUNCTION_OPS['alloc_solve_f32'] = {
    unit: {('fp32' if pipe == 'fp64' else pipe): n
           for pipe, n in mix.items()}
    for unit, mix in FUNCTION_OPS['alloc_solve'].items()}


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


def device_ms(calls, reps: int = 25, inner: int = 20,
              sleep: int = 2_000_000) -> float:
    """Median device time of one call: ``reps`` CUDA-event pairs around
    ``inner`` back-to-back calls each, taken in turn from ``calls`` (a
    list of zero-argument callables), queued behind a device sleep of
    ``sleep`` clocks (~1 ms by default; longer for calls that do more on
    the host) so host launch overhead does not open gaps between them."""
    import torch
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    times = []
    turn = 0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        for _ in range(inner):
            calls[turn % len(calls)]()
            turn += 1
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def kernel_ms(fn, tensors, args, sleep: int = 2_000_000) -> dict:
    """A kernel's launch time, from device memory and warm.  ``fn`` is
    its C entry point (or a wrapper), ``tensors`` its input and output
    tensors, and ``args(*tensors)`` its arguments (for an entry point,
    stream last) for them; ``sleep`` as in ``device_ms``.  'ms': each
    launch in turn on another of enough copies of ``tensors`` that at
    least 2 x L2_BYTES of them lie between two launches on the same copy,
    so every launch reads its inputs from device memory and the HBM bytes
    bound stays a lower bound; 'warm_ms': every launch on ``tensors``
    themselves, as a caller that has just touched them finds them."""
    import torch
    copies = cold_copies(tensors)
    calls = [(lambda a=args(*c): fn(*a)) for c in copies]
    out = {'ms': device_ms(calls, sleep=sleep),
           'warm_ms': device_ms(calls[:1], sleep=sleep)}
    del calls, copies
    torch.cuda.empty_cache()
    return out


def chain_ms(step, x, reps: int = 25, inner: int = 20,
             sleep: int = 2_000_000) -> float:
    """Median device time of one call of a dependent chain: ``reps``
    CUDA-event pairs around ``inner`` calls ``x = step(x)``, each reading
    what the call before it wrote (so a launch cannot overlap an
    independent one), queued behind a device sleep of ``sleep`` clocks;
    every chain starts again from ``x``."""
    import torch

    def run():
        y = x
        for _ in range(inner):
            y = step(y)
        return y

    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def cold_copies(tensors) -> list:
    """``tensors`` and enough copies of them that at least 2 x L2_BYTES
    of copies lie between two uses of one when they are used in turn."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    return [tuple(tensors)] + [tuple(_copy(t) for t in tensors)
                               for _ in range(-(-2 * L2_BYTES // size))]


def _copy(t):
    """A copy of ``t`` with its strides (a strided view stays strided)."""
    import torch
    out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                              device=t.device)
    return out.copy_(t)


def corrupt_fold_args(k: int, w: int, seeds, stream):
    """The C arguments of a corrupt_fold launch over (k, w) words with
    PRF ``seeds`` (the (2,) int32 words on the card) and word0 0 on the
    current stream, as a function of its tensors (words, rx, thresholds,
    all-flip flags, fold, flips)."""
    import torch
    from repro_torch.kernels import ops
    acc = ops.corrupt_fold_accumulators(
        k, torch.device('cuda', torch.cuda.current_device()))
    return lambda words, rx, th, af, fold, flips: (
        words.data_ptr(), rx.data_ptr(), th.data_ptr(), af.data_ptr(),
        acc.data_ptr(), fold.data_ptr(), flips.data_ptr(), k, w,
        seeds.data_ptr(), 0, stream)


def seed_arg(pair, dev):
    """A PRF seed pair as the imported tree's ``corrupt_fold_words``
    takes it: the (2,) int32 words on the card, or the two ints where the
    tree's kernel took them by value (``kernel_ab.py``'s earlier trees)."""
    from repro_torch.kernels import ops
    return ops.seed_words(pair, dev) if hasattr(ops, 'seed_words') else pair


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
        try:
            instrs = sass.main_path(name, sass.disassemble(lib))
        except RuntimeError as err:
            print(f'{err}; no SASS count', flush=True)
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


def quantize_pack_units(k: int, n: int, bits: int) -> dict:
    """Units of work (``sass.MAIN_PATHS``) of one quantize_pack launch:
    the threads of warps that hold a live group (every such thread runs
    the same straight-line path over its warp's groups), the words the
    warps store (a lane and a trip of the store loop each), the threads
    of warps past the last group (they exit), and the function's
    coordinates and planes."""
    from repro_torch.kernels import build
    shape = build.constants('quantize_pack')
    gpw, threads = shape['GPW'], shape['THREADS']
    groups = -(-n // 32)
    warps = -(-groups // gpw)
    blocks = -(-warps // (threads // 32))
    return dict(live_thread=k * warps * 32,
                store_word=k * groups * (1 + bits),
                idle_thread=k * (blocks * threads - warps * 32),
                coordinate=k * n, plane=k * n * bits)


def pack_bits_units(n: int, bits: int) -> dict:
    """Units of work (``sass.MAIN_PATHS``) of one pack_bits launch over n
    values: the threads of warps that hold a live group (every such
    thread runs the same straight-line path over its warp's groups), the
    words the warps store (a lane and a trip of the store loop each), the
    threads of warps past the last group (they exit), and the function's
    planes (one per value and bit)."""
    from repro_torch.kernels import build
    shape = build.constants('pack_bits')
    gpw, threads = shape['GPW'], shape['THREADS']
    groups = -(-n // 32)
    warps = -(-groups // gpw)
    blocks = -(-warps // (threads // 32))
    return dict(live_thread=warps * 32, store_word=groups * bits,
                idle_thread=blocks * threads - warps * 32, plane=n * bits)


def vector_units(name: str, n: int) -> dict:
    """Units of work (``sass.MAIN_PATHS``) of one launch of kernel
    ``name`` (dequant, quantize or roundtrip) over n coordinates whose
    rows are all 16-byte aligned (the wrapper's fresh tensors): every
    thread, the threads with coordinates, of which those that take CPT by
    vector loads and those that take one of the ragged tail, and the
    function's coordinates."""
    from repro_torch.kernels import build
    shape = build.constants(name)
    cpt, threads = shape['CPT'], shape['THREADS']
    vector = n // cpt
    tail = n - vector * cpt
    blocks = -(-(vector + tail) // threads)
    return dict(thread=blocks * threads, live_thread=vector + tail,
                vector_thread=vector, tail_thread=tail, coordinate=n)


def unpack_units(name: str, n: int, bits: int) -> dict:
    """Units of work (``sass.MAIN_PATHS``) of one launch of kernel
    ``name`` (unpack_bits or unpack_dequant) over n coordinates at
    ``bits`` on the wrapper's fresh, 16-byte aligned tensors.
    unpack_bits: its threads with a value and those past the end (they
    exit).  unpack_dequant: the lanes of the vector warps (each loads and
    stages its warp's words), the vectors of 4 coordinates (one lane
    each), the scalar threads of the ragged tail and the threads
    past the end.  Both: the function's coordinates and planes."""
    from repro_torch.kernels import build
    shape = build.constants(name)
    threads = shape['THREADS']
    if name == 'unpack_bits':
        return dict(coordinate=n, idle_thread=-(-n // threads) * threads - n,
                    plane=n * bits)
    vectors = n // 4
    warps = -(-vectors // 32)
    tail = n - 4 * vectors
    blocks = -(-(32 * warps + tail) // threads)
    return dict(warp_lane=32 * warps, vector=vectors, scalar_thread=tail,
                idle_thread=blocks * threads - 32 * warps - tail,
                coordinate=n, plane=n * bits)


def corrupt_fold_units(k: int, w: int) -> dict:
    """Units of work (``sass.MAIN_PATHS``) of one corrupt_fold launch over
    (k, w) words: every thread, the threads with a word, each word (one
    trip of a thread's loop), and for rows of more than one block the
    first thread of each block (its two atomics) and the row (the last
    block's store)."""
    from repro_torch.kernels import build
    shape = build.constants('corrupt_fold')
    threads = shape['THREADS']
    blocks = max(1, min(shape['MAX_BLOCKS'], -(-w // threads)))
    per = -(-w // blocks)
    workers = sum(min(threads, max(0, min(w, b * per + per) - b * per))
                  for b in range(blocks))
    many = blocks > 1
    return dict(thread=k * blocks * threads, worker=k * workers,
                word=k * w, block=k * blocks * many, row=k * many)


def round_units(k: int, n: int, w: int) -> dict:
    """Units of work of the four round kernels at (k clients, n
    coordinates, modulus packets of w words), where check_kernels times
    them."""
    return {'quantize_pack': quantize_pack_units(k, n, BITS),
            'spfl_accumulate': spfl_accumulate_units(k, n, BITS),
            'corrupt_fold': corrupt_fold_units(k, w),
            'fold_words': fold_words_units(k, w)}


def round_launches(sim) -> str:
    """The device operations of one more round of ``sim`` under
    ``torch.profiler``: their total and the count of each round kernel.
    The round solves eq. (28) with the uniform allocator: the solve is
    host NumPy and launches nothing, and a profile held open over the
    alternating solve's 10-20 s of host time has come back without the
    transport's kernels."""
    import dataclasses
    fl = sim.fl
    sim.fl = dataclasses.replace(fl, allocator='uniform')
    try:
        names = device_launches(sim.round_step)
    finally:
        sim.fl = fl
    ours = {kern: sum(c for name, c in names.items()
                      if f'{kern}_kernel' in name)
            for kern in kernels_on('round')}
    return f'{sum(names.values())} ({json.dumps(ours)})'


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
        bytes=k * n * 8 + k * 8 + k * groups * (1 + BITS) * 4)
    if timed:
        results['quantize_pack'].update(kernel_ms(
            build.kernel('quantize_pack'), (g, rand, gmin, gmax, sw, qw),
            lambda *t: (*(x.data_ptr() for x in t), k, n, BITS,
                        torch.cuda.current_stream().cuda_stream)))
        results['quantize_pack']['plain_ms'] = device_ms(
            [lambda: ref.quantize_pack(g, rand, gmin, gmax, BITS)], reps=20,
            inner=1)

    # --- framing, then the bit channel at a flipping operating point
    sign_words, mod_words = packets.frame_uplink_batch(
        sw, qw, gmin, gmax, n=n, bits=BITS, round_idx=3)
    q = torch.linspace(0.3, 1.0, k, device=dev)
    seeds = seed_arg((0x1234ABCD + seed, 0xFEDCBA98), dev)
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
                max_abs_err=err, bytes=2 * k * w * 4 + k * 16, words=w)
            results['fold_words'] = dict(
                max_abs_err=fold_err, bytes=k * w * 4 + k * 4)
            if timed:
                stream = torch.cuda.current_stream().cuda_stream
                results['corrupt_fold'].update(kernel_ms(
                    build.kernel('corrupt_fold'),
                    (words, rx, thresh, allf, fold, flips),
                    corrupt_fold_args(k, w, seeds, stream)))
                results['corrupt_fold']['plain_ms'] = device_ms(
                    [lambda: ref.corrupt_fold(seeds, words, thresh, allf)],
                    reps=20, inner=1)
                results['fold_words'].update(kernel_ms(
                    build.kernel('fold_words'), (rx, folded),
                    lambda x, out: (x.data_ptr(), w, out.data_ptr(), k, w,
                                    stream)))
                results['fold_words']['plain_ms'] = device_ms(
                    [lambda: ref.fold_words(rx)], reps=20, inner=1)

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
        bytes=k * groups * (1 + BITS) * 4 + n * 4 + k * 20 + n * 8)
    if timed:
        stream = torch.cuda.current_stream().cuda_stream
        tensors = (sp, mp, gbar, rmin, step, mok.contiguous(),
                   weight.contiguous(), gate, acc, votes)
        results['spfl_accumulate'].update(kernel_ms(
            build.kernel('spfl_accumulate'), tensors,
            lambda sp, mp, *t: (sp.data_ptr(), sp.stride(0), mp.data_ptr(),
                                mp.stride(0), t[0].data_ptr(), 0,
                                *(x.data_ptr() for x in t[1:]), k, n, BITS,
                                stream)))
        results['spfl_accumulate']['plain_ms'] = device_ms(
            [lambda: ref.spfl_accumulate(sp, mp, gbar, rmin, step, mok,
                                         weight, gate, n, BITS, True)],
            reps=20, inner=1)
    return results


def same_f32(a, b) -> bool:
    """Element for element equal f32 tensors (-0 equals 0), NaN where
    the other is NaN."""
    import torch
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_edges(seed: int) -> int:
    """The four round kernels and the six API kernels, bit for bit
    against their plain versions, at the shapes their tiles, client
    chunks, clusters, warps, vectors and blocks make edges (quantize_pack:
    ``_quantize_pack_edges``, corrupt_fold: ``_corrupt_fold_edges``,
    pack_bits: ``_pack_bits_edges``, dequant: ``_dequant_edges``,
    quantize: ``_quantize_edges``, roundtrip: ``_roundtrip_edges``,
    unpack_bits: ``_unpack_bits_edges``, unpack_dequant:
    ``_unpack_dequant_edges``).
    spfl_accumulate: K one client, one chunk, one past it and past two
    chunks; bits 1, 3, 16 (the planes unrolled at their narrowest, main
    and widest width), 22-24 (rolled, the two stages just under, at and
    past the 48 KB of shared memory a block gets without opting in) and
    32; n of one coordinate, around a group
    and around a tile and the main width; shared and per-client gbar;
    contiguous payload rows and rows framed as packets (strided,
    unaligned).  fold_words at K 1 and 20, W of 1, 7, one cluster's
    threads +-1 and the two packet widths, contiguous and strided.  -> the
    number of shapes checked."""
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
    shapes += _quantize_pack_edges(gen) + _corrupt_fold_edges(gen)
    shapes += _pack_bits_edges(gen) + _dequant_edges(gen)
    shapes += _quantize_edges(gen) + _roundtrip_edges(gen)
    shapes += _unpack_bits_edges(gen) + _unpack_dequant_edges(gen)
    torch.cuda.synchronize()
    return shapes


def edge_gradients(k: int, n: int, bits: int, gen):
    """(g, rand, gmin, gmax) on the card for the quantize_pack edges:
    Gaussian rows with g = -0.0 and +0.0 first; row 1 of constant |g|
    (gmin == gmax, knob step 0); every row's next coordinates with |g|
    exactly on the knob boundaries gmin + j * step of its own step, half
    of them negative, and rand 0 on every fourth coordinate."""
    import torch
    from repro_torch.core.quantize import knob_step
    dev = gen.device
    g = torch.randn((k, n), generator=gen, device=dev) * 0.1
    g[:, 0] = -0.0
    if n > 1:
        g[:, 1] = 0.0
    if k > 1:
        g[1] = -0.25
    rand = torch.rand((k, n), generator=gen, device=dev)
    rand[:, ::4] = 0.0
    a = g.abs()
    gmin, gmax = a.amin(1).contiguous(), a.amax(1).contiguous()
    step = knob_step(gmin, gmax, bits)
    m = max(0, min(n - 2, 2 ** bits))
    if m:
        j = torch.arange(m, device=dev, dtype=torch.float32)
        edge = gmin[:, None] + j[None, :] * step[:, None]
        edge[:, 1::2] = -edge[:, 1::2]
        g[:, 2:2 + m] = edge
    return g, rand, gmin, gmax


def _quantize_pack_edges(gen) -> int:
    """quantize_pack, bit for bit against its plain version: K 1, 20, 33;
    n of one coordinate, around a group, around a warp's and a block's
    groups, the main width and one past it; bits 1, 3, 8, 16; the rows of
    ``edge_gradients``.  -> the number of shapes checked."""
    from repro_torch.kernels import build, ops, ref
    shape = build.constants('quantize_pack')
    warp = 32 * shape['GPW']
    block = warp * shape['THREADS'] // 32
    shapes = 0
    for k in (1, K, 33):
        for n in (1, 31, 32, 33, warp - 1, warp + 1, block - 1, block + 1,
                  62006, 62007):
            for bits in (1, 3, 8, 16):
                g, rand, gmin, gmax = edge_gradients(k, n, bits, gen)
                _exact(f'quantize_pack k={k} n={n} bits={bits}',
                       *zip(ops.quantize_pack_flat(g, rand, gmin, gmax, bits),
                            ref.quantize_pack(g, rand, gmin, gmax, bits)))
                shapes += 1
    return shapes


# the largest f32 below 1: a BER whose flip threshold is the largest
THRESH_MAX_BER = 1.0 - 2.0 ** -24


def edge_bers(k: int, turn: int, gen):
    """(k,) BERs for the corrupt_fold edges: by (row + turn) % 4, 0
    (threshold 0), THRESH_MAX_BER (the largest threshold), 1 (all-flip
    row) or uniform in [0, 0.05)."""
    import torch
    ber = torch.rand(k, generator=gen, device=gen.device) * 0.05
    kind = (torch.arange(k, device=gen.device) + turn) % 4
    ber[kind == 0] = 0.0
    ber[kind == 1] = THRESH_MAX_BER
    ber[kind == 2] = 1.0
    return ber


def _corrupt_fold_edges(gen) -> int:
    """corrupt_fold, bit for bit against its plain version: K 1, 20, 33;
    W of 1, 7, one and two blocks' threads +-1, the two packet widths and
    MAX_BLOCKS blocks' threads +-1 (past it a thread takes several words);
    word0 0 and 2^32 - 5 (the counter wraps inside the buffer); the rows
    of ``edge_bers``.  -> the number of shapes checked."""
    import torch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.wire import corrupt as wire_corrupt
    from repro_torch.wire import format as fmt
    shape = build.constants('corrupt_fold')
    threads = shape['THREADS']
    most = shape['MAX_BLOCKS'] * threads     # past it, a row's blocks loop
    # the seed words at their edges and at random, read from the card
    pairs = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0x0BADF00D, 0x5EED1234)]
    pairs += torch.randint(0, 2 ** 32, (2, 2), dtype=torch.int64,
                           generator=torch.Generator().manual_seed(
                               int(gen.initial_seed()))).tolist()
    shapes = 0
    for k in (1, K, 33):
        for turn, w in enumerate((1, 7, threads - 1, threads + 1,
                                  2 * threads - 1, 2 * threads + 1, 1943,
                                  5822, most - 1, most + 1)):
            words = torch.randint(-2 ** 31, 2 ** 31, (k, w), generator=gen,
                                  device=gen.device, dtype=torch.int32)
            ber = edge_bers(k, turn, gen)
            thresh, allf = wire_corrupt.flip_threshold(ber)
            thresh = fmt.to_words(thresh)
            for word0 in (0, 2 ** 32 - 5):
                pair = pairs[(turn + word0) % len(pairs)]
                seeds = ops.seed_words(pair, words.device)
                _exact(f'corrupt_fold k={k} w={w} word0={word0} seeds='
                       f'{pair}',
                       *zip(ops.corrupt_fold_words(seeds, words, ber, word0),
                            ref.corrupt_fold(seeds, words, thresh, allf,
                                             word0)))
                shapes += 1
    return shapes


def _pack_bits_edges(gen) -> int:
    """pack_bits, bit for bit against its plain version: bits 1..32 on
    arbitrary words (so the bits at and above ``bits`` are dropped), at n
    of one value, around a group, around a warp's and a block's groups
    (+-1 group, +-1 value) and the main width; and bits 1, 3 and 32 on
    each row of a (3, 62,006) tensor, whose rows start 248,024 B apart
    (8 mod 16).  -> the number of shapes checked."""
    import torch
    from repro_torch.kernels import build, ops, ref
    shape = build.constants('pack_bits')
    warp = 32 * shape['GPW']
    block = warp * shape['THREADS'] // 32
    shapes = 0

    def words(*size):
        return torch.randint(-2 ** 31, 2 ** 31, size, generator=gen,
                             device=gen.device, dtype=torch.int32)

    for n in (1, 31, 32, 33, warp - 32, warp - 1, warp, warp + 1, warp + 32,
              block - 32, block - 1, block, block + 1, block + 32, 62006):
        values = words(n)
        for bits in range(1, 33):
            _exact(f'pack_bits n={n} bits={bits}',
                   (ops.pack_bits_flat(values, bits),
                    ref.pack_bits(values, bits)))
            shapes += 1
    rows = words(3, 62006)
    for i in range(3):
        for bits in (1, BITS, 32):
            _exact(f'pack_bits row {i} of (3, 62006) bits={bits}',
                   (ops.pack_bits_flat(rows[i], bits),
                    ref.pack_bits(rows[i], bits)))
            shapes += 1
    return shapes


def _dequant_edges(gen) -> int:
    """dequant, bit for bit against its plain version: n of one
    coordinate, around the vector width and the block's tile (+-1) and
    the main width; bits 1, 3, 16; a live and a zero knob step (gmin =
    gmax); mod_ok 1 and 0; through the wrapper on fresh tensors, and
    through the C entry point with every input and the output one to
    three elements past a 16-byte boundary (a scalar head, then
    vectors); and each row of (3, 62,006) sign, knob and gbar tensors
    (rows at n B and 4 n B: not aligned alike).  -> the number of shapes
    checked."""
    import torch
    from repro_torch.kernels import build, ops, ref
    shape = build.constants('dequant')
    cpt = shape['CPT']
    tile = cpt * shape['THREADS']
    dev = gen.device
    entry = build.kernel('dequant')
    stream = torch.cuda.current_stream().cuda_stream
    shapes = 0

    def one(x):
        return torch.tensor([x], dtype=torch.float32, device=dev)

    def inputs(size, bits):
        sign = torch.randint(-1, 2, size, generator=gen, device=dev,
                             dtype=torch.int8)
        qidx = torch.randint(0, 2 ** bits, size, generator=gen, device=dev,
                             dtype=torch.int32)
        gbar = torch.rand(size, generator=gen, device=dev)
        return sign, qidx, gbar

    for n in (1, 2, 3, cpt - 1, cpt, cpt + 1, 2 * cpt + 3, tile - 1, tile,
              tile + 1, 62006):
        for bits in (1, BITS, 16):
            sign, qidx, gbar = inputs((n + 3,), bits)
            for lo, hi in ((0.01, 0.7), (0.25, 0.25)):
                for ok in (1.0, 0.0):
                    args = (one(lo), one(hi), one(ok), one(0.8125))
                    at = f'n={n} bits={bits} step {lo}..{hi} mod_ok={ok}'
                    want = ref.dequant(sign[:n], qidx[:n], gbar[:n], *args,
                                       bits)
                    _exact(f'dequant {at}', (ops.dequant_compensate_flat(
                        sign[:n], qidx[:n], gbar[:n], *args, bits), want))
                    for off in (1, 2, 3):
                        out = torch.full((n + 3,), float('nan'), device=dev)
                        rc = entry(*(x[off:].data_ptr() for x in (
                            sign, qidx, gbar)), *(a.data_ptr() for a in args),
                            out[off:].data_ptr(), n, bits, stream)
                        if rc:
                            raise AssertionError(f'dequant launch {rc}')
                        _exact(f'dequant {at}, every row {off} past 16 B',
                               (out[off:off + n], ref.dequant(
                                   sign[off:off + n], qidx[off:off + n],
                                   gbar[off:off + n], *args, bits)))
                    shapes += 4
    sign, qidx, gbar = inputs((3, 62006), BITS)
    for i in range(3):
        for ok in (1.0, 0.0):
            args = (one(0.01), one(0.7), one(ok), one(1.5))
            _exact(f'dequant row {i} of (3, 62006) mod_ok={ok}',
                   (ops.dequant_compensate_flat(sign[i], qidx[i], gbar[i],
                                                *args, BITS),
                    ref.dequant(sign[i], qidx[i], gbar[i], *args, BITS)))
            shapes += 1
    return shapes


def _api_edge_sizes(name: str) -> tuple:
    """The n to sweep of a per-client API kernel with a vector body: one
    to three coordinates, around the vector width and the block's tile
    (+-1), and the main width."""
    from repro_torch.kernels import build
    shape = build.constants(name)
    cpt = shape['CPT']
    tile = cpt * shape['THREADS']
    return (1, 2, 3, cpt - 1, cpt, cpt + 1, tile - 1, tile, tile + 1, 62006)


def _quantize_edges(gen) -> int:
    """quantize, bit for bit against its plain version: n from
    ``_api_edge_sizes``; bits 1, 3, 16; the rows of ``edge_gradients``
    (g = +-0 and g on the knob boundaries; row 0 a live knob step, row 1
    a zero one); through the wrapper on fresh outputs, and through the C
    entry point with every input and output one to three elements past a
    16-byte boundary (a scalar head, then vectors), with the sign output
    at another offset than the knob output and with the inputs one
    element past the outputs' boundary (both all scalar), the memory
    around each output untouched; and each row of (3, 62,006) g and
    uniforms (rows 8 mod 16 apart) on fresh outputs.  -> the number of
    shapes checked."""
    import torch
    from repro_torch.kernels import build, ops, ref
    sizes = _api_edge_sizes('quantize')
    dev = gen.device
    entry = build.kernel('quantize')
    stream = torch.cuda.current_stream().cuda_stream
    shapes = 0
    for n in sizes:
        for bits in (1, BITS, 16):
            g, rand, gmin, gmax = edge_gradients(2, n + 3, bits, gen)
            for row, kind in ((0, 'live'), (1, 'zero')):
                x, r = g[row], rand[row]
                lo, hi = gmin[row:row + 1], gmax[row:row + 1]
                at = f'n={n} bits={bits} {kind} step'
                _exact(f'quantize {at}', *zip(
                    ops.stochastic_quantize_flat(x[:n], r[:n], lo, hi, bits),
                    ref.quantize(x[:n], r[:n], lo, hi, bits)))
                for i_off, off, s_off in ((1, 1, 1), (2, 2, 2), (3, 3, 3),
                                          (0, 0, 1), (1, 0, 0)):
                    sign = torch.full((n + 6,), 7, dtype=torch.int8,
                                      device=dev)
                    qidx = torch.full((n + 6,), -1, dtype=torch.int32,
                                      device=dev)
                    rc = entry(x[i_off:].data_ptr(), r[i_off:].data_ptr(),
                               lo.data_ptr(), hi.data_ptr(),
                               sign[s_off:].data_ptr(), qidx[off:].data_ptr(),
                               n, bits, stream)
                    if rc:
                        raise AssertionError(f'quantize launch {rc}')
                    want_s, want_q = ref.quantize(x[i_off:i_off + n],
                                                  r[i_off:i_off + n], lo, hi,
                                                  bits)
                    _exact(f'quantize {at}, inputs {i_off}, knobs {off} and '
                           f'signs {s_off} past 16 B',
                           (sign[s_off:s_off + n], want_s),
                           (qidx[off:off + n], want_q))
                    if (bool((sign[:s_off] != 7).any())
                            or bool((sign[s_off + n:] != 7).any())
                            or bool((qidx[:off] != -1).any())
                            or bool((qidx[off + n:] != -1).any())):
                        raise AssertionError(f'quantize {at}: wrote past its '
                                             'outputs')
                shapes += 6
    g, rand, gmin, gmax = edge_gradients(3, 62006, BITS, gen)
    for i in range(3):
        lo, hi = gmin[i:i + 1], gmax[i:i + 1]
        _exact(f'quantize row {i} of (3, 62006)', *zip(
            ops.stochastic_quantize_flat(g[i], rand[i], lo, hi, BITS),
            ref.quantize(g[i], rand[i], lo, hi, BITS)))
        shapes += 1
    return shapes


def _roundtrip_edges(gen) -> int:
    """roundtrip, bit for bit against its plain version: n from
    ``_api_edge_sizes``; bits 1, 3, 16; the rows of ``edge_gradients``
    (row 0 a live knob step, row 1 a zero one); mod_ok 1 and 0; through
    the wrapper on fresh tensors, and through the C entry point with g,
    the uniforms, gbar and the output one to three elements past a
    16-byte boundary, and with the inputs one element past the output's
    boundary (all scalar), the memory around the output untouched; and
    each row of (3, 62,006) g and uniforms (rows 8 mod 16 apart) against
    an aligned gbar and a fresh output.  -> the number of shapes
    checked."""
    import torch
    from repro_torch.kernels import build, ops, ref
    sizes = _api_edge_sizes('roundtrip')
    dev = gen.device
    entry = build.kernel('roundtrip')
    stream = torch.cuda.current_stream().cuda_stream
    shapes = 0

    def one(x):
        return torch.tensor([x], dtype=torch.float32, device=dev)

    for n in sizes:
        for bits in (1, BITS, 16):
            g, rand, gmin, gmax = edge_gradients(2, n + 3, bits, gen)
            gbar = torch.rand((n + 3,), generator=gen, device=dev)
            for row, kind in ((0, 'live'), (1, 'zero')):
                x, r = g[row], rand[row]
                for ok in (1.0, 0.0):
                    args = (gmin[row:row + 1], gmax[row:row + 1], one(ok),
                            one(0.8125))
                    at = f'n={n} bits={bits} {kind} step mod_ok={ok}'
                    _exact(f'roundtrip {at}', (
                        ops.spfl_roundtrip_flat(x[:n], r[:n], gbar[:n], *args,
                                                bits),
                        ref.roundtrip(x[:n], r[:n], gbar[:n], *args, bits)))
                    for i_off, off in ((1, 1), (2, 2), (3, 3), (1, 0)):
                        out = torch.full((n + 6,), float('nan'), device=dev)
                        rc = entry(*(t[i_off:].data_ptr()
                                     for t in (x, r, gbar)),
                                   *(a.data_ptr() for a in args),
                                   out[off:].data_ptr(), n, bits, stream)
                        if rc:
                            raise AssertionError(f'roundtrip launch {rc}')
                        _exact(f'roundtrip {at}, inputs {i_off} and output '
                               f'{off} past 16 B',
                               (out[off:off + n], ref.roundtrip(
                                   x[i_off:i_off + n], r[i_off:i_off + n],
                                   gbar[i_off:i_off + n], *args, bits)))
                        if not (bool(out[:off].isnan().all())
                                and bool(out[off + n:].isnan().all())):
                            raise AssertionError(f'roundtrip {at}: wrote '
                                                 'past its output')
                    shapes += 5
    g, rand, gmin, gmax = edge_gradients(3, 62006, BITS, gen)
    gbar = torch.rand((62006,), generator=gen, device=dev)
    for i in range(3):
        for ok in (1.0, 0.0):
            args = (gmin[i:i + 1], gmax[i:i + 1], one(ok), one(1.5))
            _exact(f'roundtrip row {i} of (3, 62006) mod_ok={ok}', (
                ops.spfl_roundtrip_flat(g[i], rand[i], gbar, *args, BITS),
                ref.roundtrip(g[i], rand[i], gbar, *args, BITS)))
            shapes += 1
    return shapes


def plain_unpack_dequant(sw, qw, gbar, gmin, gmax, mod_ok, weight, n: int,
                         bits: int):
    """The plain version of an ``unpack_dequant_flat`` call with the same
    arguments: ``ref.unpack_dequant`` with the knob step of
    ``knob_step(gmin, gmax, bits)``, which the kernel computes itself."""
    from repro_torch.core.quantize import knob_step
    from repro_torch.kernels import ref
    step = knob_step(gmin, gmax, bits)
    return ref.unpack_dequant(sw, qw, gbar, gmin, step, mod_ok, weight, n,
                              bits)


def _unpack_edge_sizes(name: str) -> tuple:
    """The n to sweep of an unpack kernel: one value, around a group,
    around a warp's and a block's coordinates (+-1 group, +-1 value), and
    the main width."""
    from repro_torch.kernels import build
    shape = build.constants(name)
    # unpack_bits: a value a thread; unpack_dequant: 4 a vector lane
    warp = 32 if name == 'unpack_bits' else 128
    block = warp * shape['THREADS'] // 32
    around = (warp - 32, warp - 1, warp, warp + 1, warp + 32, block - 32,
              block - 1, block, block + 1, block + 32)
    return tuple(sorted({1, 31, 32, 33, 62006, *around} - {0}))


def _unpack_bits_edges(gen) -> int:
    """unpack_bits, bit for bit against its plain version: bits 1..32 on
    arbitrary words, at n from ``_unpack_edge_sizes``, through the wrapper
    on a fresh output; at bits 1, 3 and 32 through the C entry point with
    the output one to three values past a 16-byte boundary, the memory
    around it untouched; and bits 1, 3 and 32 on each row of a (3, G * bits) word
    tensor (rows 8 mod 16 apart at bits 1 and 3).  -> the number of shapes
    checked."""
    import torch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.wire import format as fmt
    entry = build.kernel('unpack_bits')
    stream = torch.cuda.current_stream().cuda_stream
    dev = gen.device
    shapes = 0

    def words(*size):
        return torch.randint(-2 ** 31, 2 ** 31, size, generator=gen,
                             device=dev, dtype=torch.int32)

    for n in _unpack_edge_sizes('unpack_bits'):
        for bits in range(1, 33):
            w = words(fmt.payload_words(n, bits))
            want = ref.unpack_bits(w, n, bits)
            _exact(f'unpack_bits n={n} bits={bits}',
                   (ops.unpack_bits_flat(w, n, bits), want))
            shapes += 1
            if bits not in (1, BITS, 32):
                continue
            for off in (1, 2, 3):
                out = torch.full((n + 6,), -7, dtype=torch.int32, device=dev)
                rc = entry(w.data_ptr(), out[off:].data_ptr(), n, bits,
                           stream)
                if rc:
                    raise AssertionError(f'unpack_bits launch {rc}')
                _exact(f'unpack_bits n={n} bits={bits}, output {off} past '
                       '16 B', (out[off:off + n], want))
                if bool((out[:off] != -7).any()) or bool(
                        (out[off + n:] != -7).any()):
                    raise AssertionError(f'unpack_bits n={n} bits={bits}: '
                                         'wrote past its output')
                shapes += 1
    for bits in (1, BITS, 32):
        rows = words(3, fmt.payload_words(62006, bits))
        for i in range(3):
            _exact(f'unpack_bits row {i} of {tuple(rows.shape)}',
                   (ops.unpack_bits_flat(rows[i], 62006, bits),
                    ref.unpack_bits(rows[i], 62006, bits)))
            shapes += 1
    return shapes


def _unpack_dequant_edges(gen) -> int:
    """unpack_dequant, bit for bit against its plain version (with the
    knob step of ``knob_step``): n from ``_unpack_edge_sizes``; bits 1, 3,
    16; a live and a zero knob step (gmin = gmax); mod_ok 1 and 0; through
    the wrapper on fresh tensors (vectors and a scalar tail), and through
    the C entry point with the words one element past a 16-byte boundary
    and gbar and the output on it (vectors), and with the words, gbar and
    the output one to three elements past it, gbar three elements past and
    the output one, or gbar one past and the output on it (every
    coordinate scalar), the memory around the output untouched; and each
    row of (3, G) sign and (3, G * bits) knob word tensors (rows 8 mod 16
    apart) at mod_ok 1 and 0.  -> the number of shapes checked."""
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.wire import format as fmt
    entry = build.kernel('unpack_dequant')
    stream = torch.cuda.current_stream().cuda_stream
    dev = gen.device
    shapes = 0

    def one(x):
        return torch.tensor([x], dtype=torch.float32, device=dev)

    def words(*size):
        return torch.randint(-2 ** 31, 2 ** 31, size, generator=gen,
                             device=dev, dtype=torch.int32)

    for n in _unpack_edge_sizes('unpack_dequant'):
        groups = fmt.n_groups(n)
        for bits in (1, BITS, 16):
            sw, qw = words(groups + 3), words(groups * bits + 3)
            gbar = torch.rand((n + 3,), generator=gen, device=dev)
            for lo, hi in ((0.01, 0.7), (0.25, 0.25)):
                for ok in (1.0, 0.0):
                    args = (one(lo), one(hi), one(ok), one(0.8125))
                    at = f'n={n} bits={bits} step {lo}..{hi} mod_ok={ok}'

                    def want(w_off, g_off):
                        return plain_unpack_dequant(
                            sw[w_off:w_off + groups],
                            qw[w_off:w_off + groups * bits],
                            gbar[g_off:g_off + n], *args, n, bits)

                    _exact(f'unpack_dequant {at}', (ops.unpack_dequant_flat(
                        sw[:groups], qw[:groups * bits], gbar[:n], *args, n,
                        bits), want(0, 0)))
                    for w_off, g_off, off in ((1, 0, 0), (1, 1, 1),
                                              (2, 2, 2), (3, 3, 3),
                                              (1, 3, 1), (0, 1, 0)):
                        out = torch.full((n + 6,), float('nan'), device=dev)
                        rc = entry(sw[w_off:].data_ptr(),
                                   qw[w_off:].data_ptr(),
                                   gbar[g_off:].data_ptr(),
                                   *(a.data_ptr() for a in args),
                                   out[off:].data_ptr(), n, bits, stream)
                        if rc:
                            raise AssertionError(
                                f'unpack_dequant launch {rc}')
                        _exact(f'unpack_dequant {at}, words {w_off}, gbar '
                               f'{g_off} and output {off} past 16 B',
                               (out[off:off + n], want(w_off, g_off)))
                        if not (bool(out[:off].isnan().all())
                                and bool(out[off + n:].isnan().all())):
                            raise AssertionError(f'unpack_dequant {at}: '
                                                 'wrote past its output')
                    shapes += 7
    n = 62006
    groups = fmt.n_groups(n)
    sw, qw = words(3, groups), words(3, groups * BITS)
    gbar = torch.rand((n,), generator=gen, device=dev)
    for i in range(3):
        for ok in (1.0, 0.0):
            args = (one(0.01), one(0.7), one(ok), one(1.5))
            _exact(f'unpack_dequant row {i} of (3, {groups}) words '
                   f'mod_ok={ok}', (
                       ops.unpack_dequant_flat(sw[i], qw[i], gbar, *args, n,
                                               BITS),
                       plain_unpack_dequant(sw[i], qw[i], gbar, *args, n,
                                            BITS)))
            shapes += 1
    return shapes


def check_stale_outputs(seed: int) -> None:
    """corrupt_fold_words writes every output: a call, then one at another
    BER into the memory the first freed (after it was filled with ones),
    then the first call again, which must give the first call's results.
    Then calls on two streams at once, which must all give them too (each
    stream has its own accumulators).  Then ``check_pdl_hazards``."""
    import torch
    from repro_torch.kernels import ops
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    words = torch.randint(-2 ** 31, 2 ** 31, (K, 5822), generator=gen,
                          device=dev, dtype=torch.int32)
    seeds = ops.seed_words((0x600DCAFE, 0x12345678), dev)
    ber = torch.rand(K, generator=gen, device=dev) * 0.01
    first = [t.clone() for t in ops.corrupt_fold_words(seeds, words, ber)]
    torch.cuda.synchronize()
    for fill in ((-1, 0.02), (0, 0.5)):     # stale ones, then zeros
        junk = [torch.full_like(t, fill[0]) for t in first]
        del junk
        other = ops.corrupt_fold_words(seeds, words, torch.full_like(
            ber, fill[1]))
        del other
        again = ops.corrupt_fold_words(seeds, words, ber)
        for a, b, name in zip(first, again, ('received', 'fold', 'flips')):
            if not torch.equal(a, b):
                raise AssertionError(f'corrupt_fold_words {name} differs '
                                     'when its output memory was stale')
        del again
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(4):
        outs.append(ops.corrupt_fold_words(seeds, words, ber))
        with torch.cuda.stream(side):
            outs.append(ops.corrupt_fold_words(seeds, words, ber))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for out in outs:
        for a, b, name in zip(first, out, ('received', 'fold', 'flips')):
            if not torch.equal(a, b):
                raise AssertionError(f'corrupt_fold_words {name} differs '
                                     'on two streams at once')
    check_pdl_hazards(seed, reps=300)


def _pack_chain(x, steps: int, pack):
    """``steps`` calls of ``pack(values, 32)``, each on the output of the
    one before it less its first group: a 32 x 32 bit transpose per
    group, shifted by one group a call, so no short cycle can hide a
    stale read (two bare transposes are the identity)."""
    for _ in range(steps):
        x = pack(x[32:], 32)
    return x


def _dequant_chain(y, steps: int, dequant, sign, qidx, args):
    """``steps`` calls of ``dequant`` with mod_ok 0, each on the output of
    the one before it as gbar: y <- (w * s) * y, |y| growing by w = 1.25
    a call, so no short cycle can hide a stale read."""
    for _ in range(steps):
        y = dequant(sign, qidx, y, *args, BITS)
    return y


def _roundtrip_chain(y, steps: int, roundtrip, g, rand, args):
    """``steps`` calls of ``roundtrip`` with mod_ok 0, each on the output
    of the one before it as gbar: y <- (w * sign(g)) * y, as in
    ``_dequant_chain``."""
    for _ in range(steps):
        y = roundtrip(g, rand, y, *args, BITS)
    return y


def check_pdl_hazards(seed: int, reps: int = 300) -> None:
    """The kernels launched with programmatic dependent launch
    (pack_bits, dequant, quantize, roundtrip, unpack_bits, unpack_dequant:
    kernel_api_v2.cuh) wait for the kernel before them, ``reps`` times
    each, bit for bit against their plain versions:

    - read after write: chains where each call reads what the call just
      before it wrote (``_pack_chain``, ``_dequant_chain``,
      ``_roundtrip_chain``), and calls right after a copy kernel that
      writes their input;
    - write after read: pairs of launches where the second writes the
      buffer the first reads (C entry points, no call in between);
    - the chains, and quantize calls, on two streams at once
    (pack_bits and dequant here, quantize and roundtrip in
    ``_quantize_roundtrip_hazards``, unpack_bits and unpack_dequant in
    ``_unpack_hazards``)."""
    import torch
    from repro_torch.kernels import build, ops, ref
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 32 * (reps + 64)
    v0 = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    m = 62006
    sign = (torch.randint(0, 2, (m,), generator=gen, device=dev,
                          dtype=torch.int8) * 2 - 1)
    qidx = torch.randint(0, 2 ** BITS, (m,), generator=gen, device=dev,
                         dtype=torch.int32)
    g0 = torch.rand((m,), generator=gen, device=dev)
    args = tuple(torch.tensor([x], device=dev)
                 for x in (0.01, 0.7, 0.0, 1.25))
    want_p = _pack_chain(v0, reps, ref.pack_bits)
    want_d = _dequant_chain(g0, reps, ref.dequant, sign, qidx, args)
    torch.cuda.synchronize()
    _exact(f'pack_bits chain of {reps}',
           (_pack_chain(v0, reps, ops.pack_bits_flat), want_p))
    _exact(f'dequant chain of {reps}',
           (_dequant_chain(g0, reps, ops.dequant_compensate_flat, sign, qidx,
                           args), want_d))
    # a copy kernel writes the input just before each call
    x, y = torch.empty_like(v0), torch.empty_like(g0)
    vs, gs = (v0, v0.roll(7)), (g0, want_d)
    wants = [(ref.pack_bits(v, 32), ref.dequant(sign, qidx, g, *args, BITS))
             for v, g in zip(vs, gs)]
    for r in range(reps):
        x.copy_(vs[r % 2])
        p = ops.pack_bits_flat(x, 32)
        y.copy_(gs[r % 2])
        d = ops.dequant_compensate_flat(sign, qidx, y, *args, BITS)
        _exact(f'pack_bits / dequant after a copy kernel, call {r}',
               *zip((p, d), wants[r % 2]))
    # write after read: the second launch of each pair overwrites the
    # first's input
    stream = torch.cuda.current_stream().cuda_stream
    pack, deq = build.kernel('pack_bits'), build.kernel('dequant')
    y_p, other_p = torch.empty_like(v0), v0.flip(0).contiguous()
    y_d, other_d = torch.empty_like(g0), want_d.clone()
    want = (ref.pack_bits(v0, 32),
            ref.dequant(sign, qidx, g0, *args, BITS))
    ptrs = [a.data_ptr() for a in args]
    for r in range(reps):
        x.copy_(v0)
        y.copy_(g0)
        rc = (pack(x.data_ptr(), y_p.data_ptr(), n, 32, stream),
              pack(other_p.data_ptr(), x.data_ptr(), n, 32, stream),
              deq(sign.data_ptr(), qidx.data_ptr(), y.data_ptr(), *ptrs,
                  y_d.data_ptr(), m, BITS, stream),
              deq(sign.data_ptr(), qidx.data_ptr(), other_d.data_ptr(),
                  *ptrs, y.data_ptr(), m, BITS, stream))
        if any(rc):
            raise AssertionError(f'launch errors {rc}')
        _exact(f'pack_bits / dequant before a launch that overwrites '
               f'their input, pair {r}', (y_p, want[0]), (y_d, want[1]))
    # the chains on two streams at once
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    steps = max(1, reps // 3)
    xs, ys = [v0, v0], [g0, g0]
    for _ in range(steps):
        for j, s in enumerate((torch.cuda.current_stream(), side)):
            with torch.cuda.stream(s):
                xs[j] = _pack_chain(xs[j], 1, ops.pack_bits_flat)
                ys[j] = _dequant_chain(ys[j], 1, ops.dequant_compensate_flat,
                                       sign, qidx, args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    want_p = _pack_chain(v0, steps, ref.pack_bits)
    want_d = _dequant_chain(g0, steps, ref.dequant, sign, qidx, args)
    for j in range(2):
        _exact(f'pack_bits / dequant chains on two streams at once ({j})',
               (xs[j], want_p), (ys[j], want_d))
    _quantize_roundtrip_hazards(gen, reps)
    _unpack_hazards(gen, reps)


def _quantize_roundtrip_hazards(gen, reps: int) -> None:
    """``check_pdl_hazards`` for quantize and roundtrip on phase 6's
    shapes (l = 62,006, bits 3): a roundtrip chain at mod_ok 0, each
    output the next gbar; quantize and roundtrip right after a copy
    kernel that writes their g; pairs of C-entry launches where the
    second writes what the first reads (quantize: the first's g;
    roundtrip at mod_ok 0: the first's gbar); and the roundtrip chain
    and quantize calls on two streams at once."""
    import torch
    from repro_torch.kernels import build, ops, ref
    dev = gen.device
    m = 62006
    g0, r0, gmin, gmax = edge_gradients(1, m, BITS, gen)
    g0, r0 = g0[0], r0[0]
    b0 = torch.rand((m,), generator=gen, device=dev)
    lo, hi = gmin[:1], gmax[:1]
    lost = tuple(torch.tensor([x], device=dev) for x in (0.0, 1.25))
    args = (lo, hi, *lost)
    want_q = ref.quantize(g0, r0, lo, hi, BITS)
    want_c = _roundtrip_chain(b0, reps, ref.roundtrip, g0, r0, args)
    torch.cuda.synchronize()
    _exact(f'roundtrip chain of {reps}',
           (_roundtrip_chain(b0, reps, ops.spfl_roundtrip_flat, g0, r0,
                             args), want_c))
    # a copy kernel writes g just before each call
    x = torch.empty_like(g0)
    gs = (g0, -g0.roll(5))
    wants = [(*ref.quantize(v, r0, lo, hi, BITS),
              ref.roundtrip(v, r0, b0, *args, BITS)) for v in gs]
    for r in range(reps):
        x.copy_(gs[r % 2])
        s8, q32 = ops.stochastic_quantize_flat(x, r0, lo, hi, BITS)
        x.copy_(gs[(r + 1) % 2])
        out = ops.spfl_roundtrip_flat(x, r0, b0, *args, BITS)
        _exact(f'quantize / roundtrip after a copy kernel, call {r}',
               (s8, wants[r % 2][0]), (q32, wants[r % 2][1]),
               (out, wants[(r + 1) % 2][2]))
    # write after read: the second launch of each pair overwrites the
    # first's g (quantize, its knob output) or gbar (roundtrip)
    stream = torch.cuda.current_stream().cuda_stream
    quant, trip = build.kernel('quantize'), build.kernel('roundtrip')
    s8, q32 = torch.empty_like(want_q[0]), torch.empty_like(want_q[1])
    s8_other = torch.empty_like(s8)
    y, out, other = torch.empty_like(b0), torch.empty_like(b0), gs[1]
    want_r = ref.roundtrip(g0, r0, b0, *args, BITS)
    ptrs = [a.data_ptr() for a in args]
    for r in range(reps):
        x.copy_(g0)
        y.copy_(b0)
        rc = (quant(x.data_ptr(), r0.data_ptr(), lo.data_ptr(),
                    hi.data_ptr(), s8.data_ptr(), q32.data_ptr(), m, BITS,
                    stream),
              quant(other.data_ptr(), r0.data_ptr(), lo.data_ptr(),
                    hi.data_ptr(), s8_other.data_ptr(), x.data_ptr(), m,
                    BITS, stream),
              trip(g0.data_ptr(), r0.data_ptr(), y.data_ptr(), *ptrs,
                   out.data_ptr(), m, BITS, stream),
              trip(other.data_ptr(), r0.data_ptr(), b0.data_ptr(), *ptrs,
                   y.data_ptr(), m, BITS, stream))
        if any(rc):
            raise AssertionError(f'launch errors {rc}')
        _exact(f'quantize / roundtrip before a launch that overwrites '
               f'their input, pair {r}', (s8, want_q[0]), (q32, want_q[1]),
               (out, want_r))
    # the chain and quantize calls on two streams at once
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    steps = max(1, reps // 3)
    ys, quantized = [b0, b0], []
    for _ in range(steps):
        for j, st in enumerate((torch.cuda.current_stream(), side)):
            with torch.cuda.stream(st):
                quantized.append(ops.stochastic_quantize_flat(g0, r0, lo, hi,
                                                              BITS))
                ys[j] = _roundtrip_chain(ys[j], 1, ops.spfl_roundtrip_flat,
                                         g0, r0, args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    want_c = _roundtrip_chain(b0, steps, ref.roundtrip, g0, r0, args)
    for j in range(2):
        _exact(f'roundtrip chains on two streams at once ({j})',
               (ys[j], want_c))
    for k, got in enumerate(quantized):
        _exact(f'quantize on two streams at once, call {k}',
               *zip(got, want_q))


def _unpack_chain(x, steps: int, unpack):
    """``steps`` calls of ``unpack(words, n, 32)``, each on the output of
    the one before it less its first group (n a multiple of 32, so the
    values are n words again): a 32 x 32 bit transpose per group, shifted
    by one group a call, as in ``_pack_chain``."""
    for _ in range(steps):
        x = unpack(x[32:], x.shape[0] - 32, 32)
    return x


def _unpack_dequant_chain(y, steps: int, unpack_dequant, sw, qw, args):
    """``steps`` calls of ``unpack_dequant`` with mod_ok 0, each on the
    output of the one before it as gbar: y <- w * (s * y), as in
    ``_dequant_chain``."""
    for _ in range(steps):
        y = unpack_dequant(sw, qw, y, *args, y.shape[0], BITS)
    return y


def _unpack_hazards(gen, reps: int) -> None:
    """``check_pdl_hazards`` for unpack_bits and unpack_dequant: an
    unpack_bits chain at bits 32 (``_unpack_chain``) and an unpack_dequant
    chain at mod_ok 0, each output the next gbar; both right after a copy
    kernel that writes their input (the words, gbar); pairs of C-entry
    launches where the second writes what the first reads (unpack_bits:
    the first's words; unpack_dequant at mod_ok 0: its gbar); and the
    chains on two streams at once."""
    import torch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.wire import format as fmt
    dev = gen.device
    n = 32 * (reps + 64)
    v0 = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    m = 62006
    groups = fmt.n_groups(m)
    sw = torch.randint(-2 ** 31, 2 ** 31, (groups,), generator=gen,
                       device=dev, dtype=torch.int32)
    qw = torch.randint(-2 ** 31, 2 ** 31, (groups * BITS,), generator=gen,
                       device=dev, dtype=torch.int32)
    g0 = torch.rand((m,), generator=gen, device=dev)
    args = tuple(torch.tensor([x], device=dev)
                 for x in (0.01, 0.7, 0.0, 1.25))
    ref_ud = plain_unpack_dequant
    want_u = _unpack_chain(v0, reps, ref.unpack_bits)
    want_d = _unpack_dequant_chain(g0, reps, ref_ud, sw, qw, args)
    torch.cuda.synchronize()
    _exact(f'unpack_bits chain of {reps}',
           (_unpack_chain(v0, reps, ops.unpack_bits_flat), want_u))
    _exact(f'unpack_dequant chain of {reps}',
           (_unpack_dequant_chain(g0, reps, ops.unpack_dequant_flat, sw, qw,
                                  args), want_d))
    # a copy kernel writes the input just before each call
    x, y = torch.empty_like(v0), torch.empty_like(g0)
    vs, gs = (v0, v0.roll(7)), (g0, want_d)
    wants = [(ref.unpack_bits(v, n, 32), ref_ud(sw, qw, g, *args, m, BITS))
             for v, g in zip(vs, gs)]
    for r in range(reps):
        x.copy_(vs[r % 2])
        u = ops.unpack_bits_flat(x, n, 32)
        y.copy_(gs[r % 2])
        d = ops.unpack_dequant_flat(sw, qw, y, *args, m, BITS)
        _exact(f'unpack_bits / unpack_dequant after a copy kernel, call {r}',
               *zip((u, d), wants[r % 2]))
    # write after read: the second launch of each pair overwrites the
    # first's input
    stream = torch.cuda.current_stream().cuda_stream
    unpack, deq = build.kernel('unpack_bits'), build.kernel('unpack_dequant')
    y_u, other_u = torch.empty_like(v0), v0.flip(0).contiguous()
    y_d, other_d = torch.empty_like(g0), want_d.clone()
    want = (ref.unpack_bits(v0, n, 32), ref_ud(sw, qw, g0, *args, m, BITS))
    ptrs = [a.data_ptr() for a in args]
    for r in range(reps):
        x.copy_(v0)
        y.copy_(g0)
        rc = (unpack(x.data_ptr(), y_u.data_ptr(), n, 32, stream),
              unpack(other_u.data_ptr(), x.data_ptr(), n, 32, stream),
              deq(sw.data_ptr(), qw.data_ptr(), y.data_ptr(), *ptrs,
                  y_d.data_ptr(), m, BITS, stream),
              deq(sw.data_ptr(), qw.data_ptr(), other_d.data_ptr(), *ptrs,
                  y.data_ptr(), m, BITS, stream))
        if any(rc):
            raise AssertionError(f'launch errors {rc}')
        _exact(f'unpack_bits / unpack_dequant before a launch that '
               f'overwrites their input, pair {r}', (y_u, want[0]),
               (y_d, want[1]))
    # the chains on two streams at once
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    steps = max(1, reps // 3)
    xs, ys = [v0, v0], [g0, g0]
    for _ in range(steps):
        for j, st in enumerate((torch.cuda.current_stream(), side)):
            with torch.cuda.stream(st):
                xs[j] = _unpack_chain(xs[j], 1, ops.unpack_bits_flat)
                ys[j] = _unpack_dequant_chain(ys[j], 1,
                                              ops.unpack_dequant_flat, sw,
                                              qw, args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    want_u = _unpack_chain(v0, steps, ref.unpack_bits)
    want_d = _unpack_dequant_chain(g0, steps, ref_ud, sw, qw, args)
    for j in range(2):
        _exact(f'unpack_bits / unpack_dequant chains on two streams at once '
               f'({j})', (xs[j], want_u), (ys[j], want_d))


def check_grid_waits() -> list:
    """Every function of each kernel whose source waits for the kernel
    before it (``grid_dependency_wait``: programmatic dependent launch)
    executes griddepcontrol.wait before any global load or store: its
    SASS has the wait, and no path of its control flow reaches a global
    memory instruction before it (``sass.memory_before_wait``).  -> those
    kernels."""
    from repro_torch.kernels import build, sass
    names = [name for name in build.KERNELS
             if 'grid_dependency_wait()' in build.source(name).read_text()]
    for name, lib in build.build(names).items():
        for fn, instrs in sass.disassemble(lib).items():
            early = sass.memory_before_wait(instrs)
            if early:
                raise AssertionError(
                    f'{name} {fn}: {[i.text for i in early]} before the '
                    'grid dependency wait')
    return names


def device_launches(fn, tries: int = 3) -> dict:
    """{name: count} of the device operations (kernels, memsets, copies)
    that ``fn()`` runs, from ``torch.profiler``'s CUDA records.  A profile
    that holds no device record at all is taken again, up to ``tries``
    times: the profiler has now and then delivered none for one short
    launch (a kernel API call, PR 18's proof run), though the same call
    showed its kernel in every other run."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = {}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = dict(collections.Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA))
        if names:
            break
    return names


def check_corrupt_fold_launches() -> dict:
    """One ``corrupt_fold_words`` call at the main shape launches its
    kernel once and no fill or memset besides the threshold arithmetic.
    -> its device operations by name."""
    import torch
    from repro_torch.kernels import ops
    dev = torch.device('cuda')
    words = torch.zeros((K, 5822), dtype=torch.int32, device=dev)
    ber = torch.full((K,), 0.01, device=dev)
    seeds = ops.seed_words((1, 2), dev)
    ops.corrupt_fold_words(seeds, words, ber)   # warm: accumulators made
    names = device_launches(lambda: ops.corrupt_fold_words(seeds, words,
                                                           ber))
    own = sum(c for n, c in names.items() if 'corrupt_fold_kernel' in n)
    fills = {n: c for n, c in names.items()
             if 'Fill' in n or 'Memset' in n}
    if own != 1 or fills:
        raise AssertionError(f'corrupt_fold_words launched its kernel '
                             f'{own} times and fills {fills}')
    return names


def check_unpack_launches() -> dict:
    """One ``unpack_bits_flat`` and one ``unpack_dequant_flat`` call at
    phase 6's shapes, with its per-client scalars as phase 6 passes them
    (0-dim views of (K,) card tensors) and as one-element tensors, each
    run exactly one device operation: its kernel, no fill, no torch op
    (the knob step is the kernel's).  -> {call: its device operations by
    name}."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.wire import format as fmt
    dev = torch.device('cuda')
    n = 62006
    groups = fmt.n_groups(n)
    sw = torch.zeros((groups,), dtype=torch.int32, device=dev)
    qw = torch.zeros((groups * BITS,), dtype=torch.int32, device=dev)
    gbar = torch.zeros((n,), device=dev)
    col = torch.tensor([[0.01, 0.7, 1.0, 0.75]] * 2, device=dev).T
    calls = {
        'unpack_bits': lambda: ops.unpack_bits_flat(qw, n, BITS),
        'unpack_dequant': lambda: ops.unpack_dequant_flat(
            sw, qw, gbar, *(c[1] for c in col), n, BITS),
        'unpack_dequant (one-element scalars)':
            lambda: ops.unpack_dequant_flat(
                sw, qw, gbar, *(c[1:] for c in col), n, BITS),
    }
    out = {}
    for label, call in calls.items():
        call()
        names = device_launches(call)
        kernel = label.split()[0] + '_kernel'
        if sum(names.values()) != 1 or not any(kernel in k for k in names):
            raise AssertionError(f'{label}: device operations {names}, '
                                 'not its kernel alone')
        out[label] = names
    return out


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


def api_work(n: int, bits: int) -> dict:
    """{kernel: {'bytes', 'units'[, 'variants']}} of one call of each
    kernel API kernel on one client's n coordinates at ``bits``: the bytes
    the function must move (each input it needs read once, each output
    written once) and its units of work (``sass.MAIN_PATHS``); pack_bits,
    dequant, roundtrip and unpack_dequant add their other phase 6 calls
    (sign packets at bits 1; clients whose modulus packet was lost)."""
    groups = -(-n // 32)
    planes = groups * bits * 4                      # knob word bytes
    # dequant reads the sign and, by mod_ok, the knob index (mod_ok 1) or
    # gbar (mod_ok 0), never both; unpack_dequant the sign words and the
    # knob words or gbar; the roundtrip reads g and, by mod_ok, the
    # uniforms or gbar
    work = {
        'quantize': dict(bytes=n * 8 + 8 + n * 5,
                         units=vector_units('quantize', n)),
        'dequant': dict(bytes=n * 5 + 16 + n * 4,
                        units=vector_units('dequant', n)),
        'roundtrip': dict(bytes=n * 8 + 16 + n * 4,
                          units=vector_units('roundtrip', n)),
        'pack_bits': dict(bytes=n * 4 + planes,
                          units=pack_bits_units(n, bits)),
        'unpack_bits': dict(bytes=planes + n * 4,
                            units=unpack_units('unpack_bits', n, bits)),
        'unpack_dequant': dict(bytes=groups * 4 + planes + 16 + n * 4,
                               units=unpack_units('unpack_dequant', n,
                                                  bits)),
    }
    work['pack_bits']['variants'] = {'bits 1': dict(
        bytes=n * 4 + groups * 4, units=pack_bits_units(n, 1))}
    for name in ('dequant', 'roundtrip'):
        work[name]['variants'] = {'mod_ok 0': dict(work[name])}
    work['unpack_dequant']['variants'] = {'mod_ok 0': dict(
        work['unpack_dequant'], bytes=groups * 4 + n * 4 + 16 + n * 4)}
    return work


def check_api_kernels(k: int, n: int, bits: int, timed: bool, seed: int):
    """The six kernels of the per-client API against their plain versions
    on k clients' flat (n,) vectors: coordinates 0 and 1 are g = 0 and
    g = -0, but client 1 (when k > 1) has a constant |g| (knob step 0); mod_ok
    alternates 1, 0 over the clients.  Also the packers at 32 bits on
    arbitrary words.  Client 0 is timed when ``timed``."""
    import torch
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
        out = ops.unpack_dequant_flat(sw, qw, gbar, lo, hi, mok, w, n, bits)
        err['unpack_dequant'] = max(err['unpack_dequant'], _exact(
            f'unpack_dequant {at}', (out, plain_unpack_dequant(
                sw, qw, gbar, lo, hi, mok, w, n, bits))))
    words = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen,
                          device=dev, dtype=torch.int32)
    packed = ops.pack_bits_flat(words, 32)
    _exact(f'pack_bits n={n} bits=32', (packed, ref.pack_bits(words, 32)))
    _exact(f'unpack_bits n={n} bits=32',
           (ops.unpack_bits_flat(packed, n, 32), words))
    if not timed:
        return None

    results = api_work(n, bits)
    for name in results:
        results[name]['max_abs_err'] = err[name]
    # client 0 (mod_ok = 1), through the C entry points so that the timing
    # holds no wrapper overhead and no launch is counted
    lo, hi, mok, w = (x[0:1] for x in (gmin, gmax, mod_ok, weight))
    lost = torch.zeros_like(mok)
    g0, r0 = g[0], rand[0]
    sign, qidx = ref.quantize(g0, r0, lo, hi, bits)
    sbits = fmt.sign_to_bits(sign)
    sw = ref.pack_bits(sbits, 1)
    qw = ref.pack_bits(qidx, bits)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    s8 = torch.empty((n,), dtype=torch.int8, device=dev)
    q32 = torch.empty((n,), dtype=torch.int32, device=dev)
    wout, sout = torch.empty_like(qw), torch.empty_like(sw)
    # (kernel, variant) -> (tensors, the ints after their pointers, plain
    # version)
    launches = {
        ('quantize', None): ((g0, r0, lo, hi, s8, q32), (n, bits),
                             lambda: ref.quantize(g0, r0, lo, hi, bits)),
        ('dequant', None): ((sign, qidx, gbar, lo, hi, mok, w, out),
                            (n, bits), lambda: ref.dequant(
                                sign, qidx, gbar, lo, hi, mok, w, bits)),
        ('dequant', 'mod_ok 0'): ((sign, qidx, gbar, lo, hi, lost, w, out),
                                  (n, bits), lambda: ref.dequant(
                                      sign, qidx, gbar, lo, hi, lost, w,
                                      bits)),
        ('roundtrip', None): ((g0, r0, gbar, lo, hi, mok, w, out), (n, bits),
                              lambda: ref.roundtrip(g0, r0, gbar, lo, hi,
                                                    mok, w, bits)),
        ('roundtrip', 'mod_ok 0'): (
            (g0, r0, gbar, lo, hi, lost, w, out), (n, bits),
            lambda: ref.roundtrip(g0, r0, gbar, lo, hi, lost, w, bits)),
        ('pack_bits', None): ((qidx, wout), (n, bits),
                              lambda: ref.pack_bits(qidx, bits)),
        ('pack_bits', 'bits 1'): ((sbits, sout), (n, 1),
                                  lambda: ref.pack_bits(sbits, 1)),
        ('unpack_bits', None): ((qw, q32), (n, bits),
                                lambda: ref.unpack_bits(qw, n, bits)),
        ('unpack_dequant', None): (
            (sw, qw, gbar, lo, hi, mok, w, out), (n, bits),
            lambda: plain_unpack_dequant(sw, qw, gbar, lo, hi, mok, w, n,
                                         bits)),
        ('unpack_dequant', 'mod_ok 0'): (
            (sw, qw, gbar, lo, hi, lost, w, out), (n, bits),
            lambda: plain_unpack_dequant(sw, qw, gbar, lo, hi, lost, w, n,
                                         bits)),
    }
    stream = torch.cuda.current_stream().cuda_stream
    for (name, variant), (tensors, ints, plain) in launches.items():
        r = (results[name] if variant is None
             else results[name]['variants'][variant])
        r.update(kernel_ms(
            build.kernel(name), tensors,
            lambda *t, ints=ints: (*(x.data_ptr() for x in t), *ints,
                                   stream)))
        r['plain_ms'] = device_ms([plain], reps=20, inner=1)
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
        d = draws_to(draws, dev)
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


def run_sim(fl, rounds: int, label: str, hook=None, data=None,
            expect=None, ran=None):
    """``rounds`` rounds of ``build_simulator(fl)`` at full width, with
    every launch counter reset just before and read just after; ``hook``
    (if any) is called with the simulator before the rounds.  ``data``
    (``data_of`` another simulator) skips making the data set again.
    Raises if a kernel of ``expect`` (default: the four round kernels)
    was never launched.  ``ran`` (a dict): the run goes under
    ``torch.profiler`` and ``ran`` gets the count of each of the port's
    kernels in the card's record of it, a CUDA graph's replays included
    (the wrappers count a captured launch once, where it is issued)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.training.fl_loop import FLSimulator, build_simulator

    t0 = time.perf_counter()
    if data is None:
        sim = build_simulator(fl, per_device=500, n_test=2000)
    else:
        sim = FLSimulator(fl, *data)
    print(f'{label}: set-up {time.perf_counter() - t0:.3f} s '
          f'(K={sim.K}, l={sim.dim})', flush=True)
    if hook is not None:
        hook(sim)
    ops.reset_launch_counts()
    if ran is None:
        hist = sim.run(rounds)
    else:
        out = []
        names = device_launches(lambda: out.append(sim.run(rounds)),
                                tries=1)
        hist = out[0]
        kinds = op_kinds(names)
        ran.update({name: kinds.get(name, 0) for name in ops.launch_counts})
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    per_round = len(hist.loss) == rounds
    for n in range(rounds):
        evals = (f'loss {hist.loss[n]:.6f} acc {hist.test_acc[n]:.4f} '
                 if per_round else '')
        print(f'{label} round {n}: {hist.round_time_s[n] * 1e3:.3f} ms '
              f'(eq. (28) host {hist.alloc_time_s[n] * 1e3:.3f} ms, '
              f'{fl.allocation_backend} backend) {evals}'
              f'payload_bits {hist.payload_bits[n]:.0f}', flush=True)
    print(f'{label} launches: {json.dumps(counts)}', flush=True)
    if ran is not None:
        print(f'{label} kernels the card ran (torch.profiler): '
              f'{json.dumps(ran)}', flush=True)
    if len(hist.loss) != rounds:
        # fused rounds evaluate at segment boundaries
        print(f'{label} evaluations (one a segment): loss '
              f'{json.dumps(hist.loss)} acc {json.dumps(hist.test_acc)}',
              flush=True)
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f'{label}: non-finite loss {hist.loss}')
    expect = kernels_on('round') if expect is None else expect
    missing = [name for name in expect if counts[name] <= 0]
    if missing:
        raise AssertionError(f'{label}: kernels never launched: {missing}')
    return sim, hist, counts


def data_of(sim) -> tuple:
    """A simulator's client and test images and labels, as the host
    arrays ``FLSimulator`` takes."""
    def nhwc(x):
        return x.movedim(-3, -1).cpu().numpy()
    return (nhwc(sim.client_x), sim.client_y.cpu().numpy(),
            nhwc(sim.test_x), sim.test_y.cpu().numpy())


def api_client(g, r, gbar, args, sw, qw, check: bool = True):
    """Phase 6's kernel API calls for one client, in its order: quantize
    ``g`` with uniforms ``r``, pack its knob indices and signs, unpack
    the knob words, the roundtrip and dequant, and unpack_dequant of the
    client's quantize_pack words ``sw``, ``qw``; ``args`` are its gmin,
    gmax, mod_ok and weight.  -> ({identity: holds} of (a)-(d) of
    ``run_kernel_api``, the contribution).  Each identity is read on the
    host as soon as its operands are queued, which waits for the card;
    ``check=False`` queues the same calls and reads nothing, and the
    identities are then None."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.wire import format as fmt

    def equal(a, b):
        return torch.equal(a, b) if check else None

    n = g.shape[0]
    sign, qidx = ops.stochastic_quantize_flat(g, r, args[0], args[1], BITS)
    words = ops.pack_bits_flat(qidx, BITS)
    checks = {'a': equal(words, qw)}
    checks['b'] = equal(ops.pack_bits_flat(fmt.sign_to_bits(sign), 1), sw)
    checks['c'] = equal(ops.unpack_bits_flat(words, n, BITS), qidx)
    checks['d'] = equal(ops.spfl_roundtrip_flat(g, r, gbar, *args, BITS),
                        ops.dequant_compensate_flat(sign, qidx, gbar, *args,
                                                    BITS))
    return checks, ops.unpack_dequant_flat(sw, qw, gbar, *args, n, BITS)


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
        checks, contrib = api_client(grads[i], rand[i], gbar, args, sw[i],
                                     qw[i])
        failed += [f'({c}) client {i}' for c, ok in checks.items() if not ok]
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


# ---------------------------------------------------------------------------
# the on-device eq. (28) solver (alloc_solve)
# ---------------------------------------------------------------------------

# the engine-parity contract of src/repro/core/README.md
ALLOC_CONTRACT = {
    'alternating': dict(obj_rtol=1e-8, ab_atol=1e-4, qp_atol=1e-6),
    'barrier': dict(obj_rtol=2e-5, ab_atol=5e-3, qp_atol=1e-4),
}
ALLOC_POWERS = (-4.0, -14.0, -24.0, -34.0)


def alloc_problem(k: int, power_dbm: float, seed: int, dim: int = 60000):
    """A host eq. (28) problem made with NumPy from ``seed``, as the CPU
    tests make theirs (tests/test_torch_allocation_jax.py)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import allocation as PA
    fl = dataclasses.replace(FLConfig(), tx_power_dbm=power_dbm)
    rng = np.random.RandomState(seed)
    u = rng.uniform(0.0, 1.0, k)
    dist = np.sqrt(10.0 ** 2 + (500.0 ** 2 - 10.0 ** 2) * u).astype(
        np.float32)
    g2 = np.abs(rng.randn(k)) + 0.2
    gb2 = np.abs(rng.randn(k)) * 0.4 + 0.05
    v = np.sqrt(g2 * gb2) * rng.uniform(0, 1, k)
    d2 = np.abs(rng.randn(k)) * 0.05
    return PA.problem_from_stats(g2, gb2, v, d2, dist ** (-fl.path_loss_exp),
                                 np.full(k, fl.tx_power_w), dim, fl)


def alloc_units(trips, k: int, n_grid: int = 256) -> dict:
    """Units of work (``FUNCTION_OPS['alloc_solve']``) of one solve of k
    clients from the kernel's trip counts (``ops.ALLOC_TRIPS`` order):
    the sequential function's (the speculative golden sections are not
    the function's work).  A golden pair is a golden step on each of the
    client's lanes (two where 2k lanes fit a block)."""
    from repro_torch.kernels import build, ops
    t = dict(zip(ops.ALLOC_TRIPS, (int(x) for x in trips)))
    lanes = 2 if 2 * k <= build.constants('alloc_solve')['BLOCK'] else 1
    return {'grid_point': t['alpha'] * n_grid * k,
            'newton_step': t['newton'], 'bracket': t['chains'],
            'alpha_client': t['alpha'] * k, 'golden_pair': t['eval'] * k,
            'golden_step': t['eval'] * k * lanes,
            'golden_call': t['golden'] * k, 'sca_round': t['sca'] * k,
            'objective': t['objective'] * k,
            'barrier_step': t['barrier'] * k,
            'backtrack': t['backtrack'] * k}


def alloc_bytes(nb: int, k: int, max_iters: int, real: int = 8) -> int:
    """Bytes a solve of nb problems of k clients must move, in reals of
    ``real`` bytes (8: float64, 4: float32): each input read once (four
    coefficients, gains, budgets and mask per client, six scalars per
    problem), each output written once (alpha, beta, q, p per client;
    objective, iterations, objectives and exit reason per problem)."""
    return nb * (k * 7 * real + 6 * real + k * 4 * real + real + 4
                 + max_iters * real + 4)


def alloc_rows(sol, ks) -> list:
    """A batched JaxAllocation as one host dict per problem, on its real
    clients."""
    host = {f: getattr(sol, f).cpu() for f in sol._fields}
    return [{f: (v[i, :k] if f in ('alpha', 'beta', 'q', 'p') else v[i])
             for f, v in host.items()} for i, k in enumerate(ks)]


def alloc_compare(got, want, ks, method: str, label: str) -> float:
    """Problem by problem, ``got`` within ``method``'s contract of
    ``want`` (both batched JaxAllocations; iterations and exit reasons
    equal); prints whether they agree bit for bit and, if not, on which
    outputs.  -> the largest difference of any output."""
    import torch
    tol = ALLOC_CONTRACT[method]
    worst, differ = 0.0, set()
    for i, (a, b) in enumerate(zip(alloc_rows(got, ks), alloc_rows(want,
                                                                   ks))):
        for f in a:
            x, y = a[f].double(), b[f].double()
            if not torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0)):
                differ.add(f)
            worst = max(worst, float((x - y).abs().nan_to_num(0.0).max()))
        if int(a['iters']) != int(b['iters']) or \
                int(a['exit_reason']) != int(b['exit_reason']):
            raise AssertionError(f'{label} problem {i}: iterations or exit '
                                 'reason differ')
        obj = float(b['objective'])
        if abs(float(a['objective']) - obj) > max(
                tol['obj_rtol'] * abs(obj), 1e-12):
            raise AssertionError(f'{label} problem {i}: objective')
        for f, key in (('alpha', 'ab_atol'), ('beta', 'ab_atol'),
                       ('q', 'qp_atol'), ('p', 'qp_atol')):
            if float((a[f] - b[f]).abs().max()) > tol[key]:
                raise AssertionError(f'{label} problem {i}: {f}')
    same = 'bit for bit' if not differ else \
        f'within the contract, bits differ in {sorted(differ)}'
    print(f'{label}: {len(ks)} problems {same} (largest difference '
          f'{worst:.3e})', flush=True)
    return worst


def check_alloc_kernel(seed: int) -> dict:
    """The solver kernel on the card: (i) against its plain version on
    the same card tensors, one batched call per method on the CPU tests'
    parity grid (K in {4, 8} x 4 powers) plus one K=20 problem, padded
    to K=20, at max_iters=2; (ii) the batch against each problem alone
    (unpadded) and the K=8 problems as a batch of one size, bit for bit.
    -> {'max_abs_err', 'plain_s'}."""
    import torch
    from repro_torch.core import allocation_jax as AJ
    from repro_torch.kernels import ops
    probs = [alloc_problem(k, p, 10 * k + int(-p)) for k in (4, 8)
             for p in ALLOC_POWERS] + [alloc_problem(20, -14.0, seed)]
    ks = [p.n for p in probs]
    batch = AJ.stack_problems(probs, device='cuda')
    out = {'max_abs_err': 0.0, 'plain_s': {}}
    for method in ('alternating', 'barrier'):
        kern = ops.alloc_solve(batch, method, max_iters=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = AJ.solve_plain(batch, method, max_iters=2)
        torch.cuda.synchronize()
        out['plain_s'][method] = time.perf_counter() - t0
        out['max_abs_err'] = max(out['max_abs_err'], alloc_compare(
            kern, plain, ks, method, f'alloc_solve {method}: kernel vs '
            f'plain (plain {out["plain_s"][method]:.1f} s)'))
        singles = [ops.alloc_solve(AJ.from_reference(p, device='cuda'),
                                   method, max_iters=2) for p in probs]
        for i, (one, k) in enumerate(zip(singles, ks)):
            row = AJ.JaxAllocation(*(x[i] for x in kern))
            for f in one._fields:
                a, b = getattr(row, f), getattr(one, f)
                if f in ('alpha', 'beta', 'q', 'p'):
                    a = a[:k]
                if not torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)):
                    raise AssertionError(f'alloc_solve {method}: ragged '
                                         f'batch != alone, problem {i} {f}')
        same = [i for i, k in enumerate(ks) if k == 8]
        homo = ops.alloc_solve(AJ.stack_problems([probs[i] for i in same],
                                                 device='cuda'),
                               method, max_iters=2)
        for j, i in enumerate(same):
            for f in homo._fields:
                if not torch.equal(getattr(homo, f)[j].nan_to_num(7.0),
                                   getattr(singles[i], f).nan_to_num(7.0)):
                    raise AssertionError(f'alloc_solve {method}: batch != '
                                         f'alone, problem {i} {f}')
        print(f'alloc_solve {method}: ragged batch == each alone, batch '
              f'of K=8 == each alone, bit for bit', flush=True)
    return out


# K on every edge of the solver kernel's layout (ops.alloc_layout): the
# most groups a block (63) up to K = 2, 3 the next; two lanes a client up
# to 128, one group a block from 65; one block a problem up to 256, then
# 2, 3 and 4 blocks (parts) a copy of the problem
ALLOC_EDGES = (1, 2, 3, 20, 64, 65, 128, 129, 256, 257, 512, 513, 768, 769,
               1024)
BARRIER_EDGE_ITERS = 1


def check_alloc_layouts(seed: int) -> dict:
    """The solver kernel on every edge of its layout: (i) each K of
    ``ALLOC_EDGES`` alone (its own layout: lanes, groups, parts and
    cluster) against one plain solve of all of them padded to the
    largest K, bit for bit, alternating at ``max_iters=1`` with and
    without the tolerance exits (inner_tol 1e-9: the groups' votes);
    (ii) batches of 20 and 140 K=20 problems (a cluster of 6 blocks a
    problem, then of 1: B x blocks <= the SMs) each equal to its problem
    alone (a cluster of 8); (iii) the barrier method at K = 257 (two
    blocks a problem) against its plain solve, bit for bit, at
    ``BARRIER_EDGE_ITERS`` outer iterations.  -> {'plain_s'}."""
    import torch
    from repro_torch.core import allocation_jax as AJ
    from repro_torch.kernels import ops
    probs = [alloc_problem(k, -14.0, seed + k) for k in ALLOC_EDGES]
    batch = AJ.stack_problems(probs, device='cuda')
    out = {'plain_s': 0.0}
    for inner_tol in (0.0, 1e-9):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = AJ.solve_plain(batch, 'alternating', max_iters=1,
                               inner_tol=inner_tol)
        torch.cuda.synchronize()
        out['plain_s'] += time.perf_counter() - t0
        for i, (p, k) in enumerate(zip(probs, ALLOC_EDGES)):
            one = ops.alloc_solve(AJ.from_reference(p, device='cuda'),
                                  'alternating', max_iters=1,
                                  inner_tol=inner_tol)
            for f in one._fields:
                a, b = getattr(one, f), getattr(plain, f)[i]
                if f in ('alpha', 'beta', 'q', 'p'):
                    b = b[:k]
                if not torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)):
                    raise AssertionError(
                        f'alloc_solve K={k} (layout '
                        f'{ops.alloc_layout(1, k)}, inner_tol {inner_tol}): '
                        f'kernel != plain in {f}')
        print(f'alloc_solve layouts: K = {list(ALLOC_EDGES)} each alone vs '
              f'plain (inner_tol {inner_tol}), bit for bit', flush=True)
    for k in ALLOC_EDGES:
        print(f'alloc_solve layout K={k}: {json.dumps(ops.alloc_layout(1, k))}',
              flush=True)
    # the barrier method where a problem spans two blocks (K = 257), at
    # one outer iteration: its plain solve takes ~25 s on the card (53 s
    # at two)
    prob = AJ.from_reference(alloc_problem(257, -14.0, seed + 257),
                             device='cuda')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = AJ.solve_plain(prob, 'barrier', max_iters=BARRIER_EDGE_ITERS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out['plain_s'] += dt
    one = ops.alloc_solve(prob, 'barrier', max_iters=BARRIER_EDGE_ITERS)
    for f in one._fields:
        if not torch.equal(getattr(one, f).nan_to_num(7.0),
                           getattr(plain, f).nan_to_num(7.0)):
            raise AssertionError(f'alloc_solve barrier K=257 (layout '
                                 f'{ops.alloc_layout(1, 257, "barrier")}):'
                                 f' kernel != plain in {f}')
    print(f'alloc_solve barrier K=257 (layout '
          f'{json.dumps(ops.alloc_layout(1, 257, "barrier"))}, max_iters '
          f'{BARRIER_EDGE_ITERS}, iters_used {int(one.iters)}, exit_reason '
          f'{int(one.exit_reason)}): kernel vs plain bit for bit (plain '
          f'{dt:.3f} s)', flush=True)
    base = [alloc_problem(K, p, seed + i) for i, p in enumerate(ALLOC_POWERS)]
    singles = [ops.alloc_solve(AJ.from_reference(p, device='cuda'),
                               'alternating', max_iters=2) for p in base]
    for nb in (20, 140):
        got = ops.alloc_solve(AJ.stack_problems(
            [base[i % len(base)] for i in range(nb)], device='cuda'),
            'alternating', max_iters=2)
        for i in range(nb):
            for f in got._fields:
                if not torch.equal(
                        getattr(got, f)[i].nan_to_num(7.0),
                        getattr(singles[i % len(base)], f).nan_to_num(7.0)):
                    raise AssertionError(f'alloc_solve: a batch of {nb} != '
                                         f'alone, problem {i} {f}')
        print(f'alloc_solve: a batch of {nb} K={K} problems (layout '
              f'{json.dumps(ops.alloc_layout(nb, K))}) == each alone '
              f'({json.dumps(ops.alloc_layout(1, K))}), bit for bit',
              flush=True)
    return out


def check_spills() -> None:
    """What ptxas reported for the solver kernel's build (``-Xptxas
    -v``): registers, stack and spills of each function; raises if any
    spills."""
    from repro_torch.kernels import build
    report = build.ptxas_report('alloc_solve')
    for fn, info in sorted(report.items()):
        print(f'alloc_solve ptxas: {fn}: {json.dumps(info)}', flush=True)
    spilled = {fn: info for fn, info in report.items()
               if info.get('spill_stores') or info.get('spill_loads')}
    if spilled or not report:
        raise AssertionError(f'alloc_solve spills: {spilled or report}')


def keep_host_solves(sim, kept: list) -> None:
    """Keep each round's host problem and solution of a 'numpy'-backend
    simulator (its allocate, wrapped)."""
    allocate = sim.allocate

    def wrapped(grads, gbar, gains=None):
        sol, stats = allocate(grads, gbar, gains)
        kept.append((stats['prob'], sol))
        return sol, stats

    sim.allocate = wrapped


def keep_device_problems(sim, kept: list) -> None:
    """Keep each round's device problem and stats of a 'jax'-backend
    simulator (its allocate_on_device, wrapped)."""
    allocate = sim.allocate_on_device

    def wrapped(grads, gbar, gains=None, *p_w):
        sol, stats = allocate(grads, gbar, gains, *p_w)
        kept.append(stats)
        return sol, stats

    sim.allocate_on_device = wrapped


def check_host_problems(kept: list, max_iters: int,
                        label: str = "the main run's") -> float:
    """The kernel on a run's own host problems (the rounds that solved),
    at that run's max_iters, within the alternating contract of the host
    solutions.  -> the largest difference."""
    import numpy as np
    import torch
    from repro_torch.core import allocation_jax as AJ
    from repro_torch.kernels import ops
    solved = [(prob, sol) for prob, sol in kept
              if sol.info['method'] == 'alternating']
    if not solved:
        raise AssertionError('the main run solved no round')
    batch = AJ.stack_problems([prob for prob, _ in solved], device='cuda')
    got = ops.alloc_solve(batch, 'alternating', max_iters=max_iters)
    f64 = dict(dtype=torch.float64)
    want = AJ.JaxAllocation(
        *(torch.as_tensor(np.stack([getattr(sol, f) for _, sol in solved]),
                          **f64) for f in ('alpha', 'beta', 'q', 'p')),
        torch.tensor([sol.objective for _, sol in solved], **f64),
        torch.tensor([sol.info['iters_used'] for _, sol in solved],
                     dtype=torch.int32),
        got.objectives.cpu(),
        torch.tensor([sol.info['exit_reason'] for _, sol in solved],
                     dtype=torch.int32))
    return alloc_compare(got, want, [prob.n for prob, _ in solved],
                         'alternating', f'alloc_solve on {label} host '
                         f'problems (max_iters={max_iters}) vs the host solve')


def spine_only(trips: dict, nodes: int) -> bool:
    """Whether every dual search of a solve walked the spine (the
    bisection's rounds down the infeasible side, which the kernel takes
    while the bracket's top is infeasible; ``csrc/alloc_solve.cu``), read
    from its trip counts: a spine round of L =
    (nodes + 1) / 2 levels leaves L - 1 speculative sections, so a dual
    on the spine throughout leaves BISECT_STEPS minus its rounds, and one
    full round of the tree of 6 levels alone leaves 57."""
    from repro_torch.core.allocation_jax import BISECT_STEPS
    levels = (nodes + 1) // 2
    rounds = -(-BISECT_STEPS // levels)
    return trips['spec_golden'] <= trips['dual'] * (BISECT_STEPS - rounds)


def time_device_solves(sim, kept: list, label: str = 'main-jax') -> list:
    """Each kept round's solve again, alone: its kernel time (CUDA events,
    median of 5), trip counts, effort and whether its dual searches kept
    to the spine.  -> one dict per round."""
    import torch
    from repro_torch.kernels import ops
    fl = sim.fl
    layout = ops.alloc_layout(1, sim.K, fl.allocator)
    print(f'{label} solve layout (K={sim.K}): {json.dumps(layout)}',
          flush=True)
    out = []
    for n, stats in enumerate(kept):
        prob, gate = stats['prob'], torch.amax(stats['gb2'])
        trips = torch.zeros((1, len(ops.ALLOC_TRIPS)), dtype=torch.int32,
                            device='cuda')

        def solve(prob=prob, gate=gate, trips=trips):
            return ops.alloc_solve(
                prob, fl.allocator, max_iters=fl.allocation_max_iters or 6,
                tol=fl.allocation_tol or 1e-5,
                early_exit=fl.allocation_early_exit, gate=gate, trips=trips)

        ms = device_ms([solve], reps=5, inner=1)
        sol = solve()
        torch.cuda.synchronize()
        named = dict(zip(ops.ALLOC_TRIPS, trips[0].tolist()))
        spine = spine_only(named, layout['nodes'])
        out.append(dict(round=n, ms=ms, iters=int(sol.iters),
                        exit_reason=int(sol.exit_reason),
                        trips=trips[0].tolist(), prob=prob, gate=gate,
                        sol=sol, spine=spine))
        print(f'{label} round {n}: alloc_solve kernel {ms:.4f} ms, '
              f'iters_used {int(sol.iters)}, exit_reason '
              f'{int(sol.exit_reason)}, spine only {spine}, trips '
              f'{json.dumps(named)}', flush=True)
    return out


def check_no_sync(sim, label: str = 'main-jax', gains=None) -> None:
    """A 'jax'-backend round from its gradients to (q, p) queues its work
    without a host synchronization: the stats, the problem (on ``gains``,
    a device row of the fading trajectory, if given), the solve and the
    casts run under ``torch.cuda.set_sync_debug_mode('error')``, which
    raises at any operation that waits for the card."""
    import torch
    _, grads = sim.client_grads(sim.params)
    torch.cuda.set_sync_debug_mode('error')
    try:
        sol, _ = sim.allocate_on_device(grads, sim.gbar, gains)
        sol.q.to(torch.float32), sol.p.to(torch.float32)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    print(f'{label}: from the gradients to (q, p) nothing waits for the '
          "card (sync debug mode 'error')", flush=True)


ROUND_SPANS = ('round/gradients', 'round/stats', 'round/solve',
               'round/transport', 'round/update', 'round/evaluation')


def round_split(sim, tries: int = 3, label: str = 'main-jax',
                spans=ROUND_SPANS) -> dict:
    """One more round of ``sim`` (and its evaluation) under
    ``torch.profiler``: for each of its ``spans`` (``round/...`` in
    ``training.fl_loop``) the host ms and the device ms (the profiler's
    device-side span of the annotation: from the first to the end of the
    last device operation launched in it), the device's busy ms (the sum
    of its operations) and idle share of the round's wall time, and the
    operations that took most of it.  A profile without device records
    is taken again on the next round, up to ``tries`` rounds (see
    ``device_launches``)."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    cpu = torch.autograd.DeviceType.CPU
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim.run(1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        host = collections.Counter()
        device = collections.Counter()
        ops = collections.Counter()
        for e in prof.events():
            ms = (e.time_range.end - e.time_range.start) / 1e3
            if e.device_type == cpu:
                if e.name.startswith('round/'):
                    host[e.name] += ms
            elif e.name.startswith('round/'):
                device[e.name] += ms
            else:
                ops[e.name.split('(')[0][:48]] += ms
        busy = sum(ops.values())
        if busy > 0.0:
            break
    print(f'{label} round split (torch.profiler, one round): wall '
          f'{wall:.3f} ms, device busy {busy:.3f} ms (idle share '
          f'{1 - busy / wall:.4f})', flush=True)
    for name in spans:
        print(f'  {name}: host {host.get(name, 0.0):.3f} ms, device '
              f'{device.get(name, 0.0):.3f} ms', flush=True)
    print(f'  device operations, most time first: '
          f'{json.dumps(dict(ops.most_common(6)))} ms', flush=True)
    if busy <= 0.0:
        raise AssertionError('the profiler recorded no device time')
    return {'wall_ms': wall, 'host': dict(host), 'device': dict(device),
            'busy_ms': busy}


# ---------------------------------------------------------------------------
# phase 7: per-round fading cadence and the paper's baselines
# ---------------------------------------------------------------------------

def check_counts(label: str, counts: dict, want: dict) -> None:
    """Raise unless each kernel of ``want`` launched exactly that often."""
    wrong = {name: counts[name] for name, n in want.items()
             if counts[name] != n}
    if wrong:
        raise AssertionError(f'{label}: launches {wrong}, want {want}')


def host_problems(sim, kept: list, rounds, max_iters: int) -> list:
    """The kept 'jax' rounds ``rounds`` as host problems (their device
    stats, gains and float32-rounded budgets, brought to the host) with
    their host solutions (alternating, ``max_iters``)."""
    from repro_torch.core import allocation as alloc
    out = []
    for n in rounds:
        st = kept[n]
        host = {f: st[f].cpu().numpy() for f in ('g2', 'gb2', 'v', 'd2')}
        prob = alloc.problem_from_stats(
            host['g2'], host['gb2'], host['v'], host['d2'],
            st['prob'].gains.cpu().numpy(), st['prob'].p_w.cpu().numpy(),
            sim.dim, sim.fl)
        t0 = time.perf_counter()
        sol = alloc.solve(prob, 'alternating', max_iters=max_iters)
        print(f'fading-jax round {n}: host solve of its problem '
              f'{time.perf_counter() - t0:.3f} s', flush=True)
        out.append((prob, sol))
    return out


def check_error_free_round(sim) -> None:
    """One error_free round's packed transport on the card against the
    same round through the plain versions on the CPU, same gradients and
    uniforms: the framed words and every integer bit for bit, the
    aggregate within the FMA-wobble bound."""
    import torch
    from repro_torch.core import transport
    _, grads = sim.client_grads(sim.params)
    grads = grads.detach()
    draws = sim.draw()
    out = {}
    for dev in ('cuda', 'cpu'):
        g, d = grads.to(dev), draws._replace(rand=draws.rand.to(dev))
        words = transport.encode_wire(g, d.rand, BITS, 0)[:2]
        ghat, rec = transport.error_free_aggregate(g, sim.fl, d, round_idx=0)
        out[dev] = ([w.cpu() for w in words], ghat.cpu(), rec.to_host())
    (w_gpu, g_gpu, r_gpu), (w_cpu, g_cpu, r_cpu) = out['cuda'], out['cpu']
    if not all(torch.equal(a, b) for a, b in zip(w_gpu, w_cpu)):
        raise AssertionError('error_free words: card != CPU')
    for name in ('sign_ok', 'mod_ok', 'payload_bits', 'sign_votes'):
        if not (getattr(r_gpu, name) == getattr(r_cpu, name)).all():
            raise AssertionError(f'error_free {name}: card != CPU')
    k = grads.shape[0]
    tol = ulp_atol(torch.ones(k), grads.abs().amax(1).cpu(),
                   torch.zeros(1)) / k
    err = float((g_gpu - g_cpu).abs().max())
    if err > tol:
        raise AssertionError(f'error_free ghat: card - CPU {err} > {tol}')
    print(f'error_free round: card vs CPU plain versions: '
          f'{sum(w.numel() for w in w_gpu)} words bit for bit, ghat max '
          f'|diff| {err:.3e} (bound {tol:.3e})', flush=True)


# dds and scheduling lose packets here at K=20 on the main path's
# geometry: mean q ~0.51 (dds, beta 1/K) and ~0.54 (the scheduled, beta
# 1/15), from single_packet_success_prob on the seed-0 distances
LOW_POWER_DBM = -45.0


def draws_to(draws, dev):
    """A transport's draws with every tensor on ``dev``."""
    import torch
    return draws._replace(**{f: v.to(dev) for f, v in draws._asdict().items()
                             if isinstance(v, torch.Tensor)})


def check_baseline_round(label: str, sim) -> None:
    """One round of a single-packet baseline (dds or scheduling) on the
    card against the same round on the CPU, same gradients and draws:
    the packet verdicts bit for bit, with an erasure among them, and the
    aggregate within the FMA-wobble bound of the received mean."""
    import torch
    from repro_torch.core import transport
    _, grads = sim.client_grads(sim.params)
    grads = grads.detach()
    draws = sim.draw()
    fl = sim.fl
    out = {}
    for dev in ('cuda', 'cpu'):
        g, d = grads.to(dev), draws_to(draws, dev)
        gains, p_w = sim.gains_f32.to(dev), sim.p_w_f32.to(dev)
        if fl.transport == 'dds':
            ghat, rec = transport.dds_aggregate(
                g, sim.beta_uniform.to(dev), gains, p_w, fl, d)
        else:
            ghat, rec = transport.scheduling_aggregate(g, gains, p_w, fl, d)
        out[dev] = (ghat.cpu(), rec.to_host())
    (g_gpu, r_gpu), (g_cpu, r_cpu) = out['cuda'], out['cpu']
    for name in ('sign_ok', 'mod_ok', 'accepted', 'payload_bits'):
        if not (getattr(r_gpu, name) == getattr(r_cpu, name)).all():
            raise AssertionError(f'{label} {name}: card != CPU')
    ok = torch.as_tensor(r_gpu.sign_ok)
    if bool(ok.all()) or not bool(ok.any()):
        raise AssertionError(f'{label}: the checked round has no erasure '
                             'or no packet')
    tol = ulp_atol(ok.to(torch.float32), grads.abs().amax(1).cpu(),
                   torch.zeros(1)) / int(ok.sum())
    err = float((g_gpu - g_cpu).abs().max())
    if err > tol:
        raise AssertionError(f'{label} ghat: card - CPU {err} > {tol}')
    print(f'{label} round: card vs CPU: verdicts bit for bit, '
          f'{int(ok.sum())} of {ok.numel()} packets received, ghat max '
          f'|diff| {err:.3e} (bound {tol:.3e})', flush=True)


def run_fading_and_baselines(main_sim) -> dict:
    """Phase 7, each run with the launch counters reset just before and
    read just after (``run_sim``):

    * per-round cadence, 'jax' backend (``build_simulator``, 5 rounds):
      one ``alloc_solve`` a round on that round's gains and the four round
      kernels; the trajectory's rows differ; nothing from the gradients
      to (q, p) waits for the card; each solve timed alone, with its
      trips and whether it kept to the spine; rounds 1 and 4's problems
      solved by the host solver and by the kernel, within the contract;
    * per-round cadence, 'numpy' backend (2 rounds): two host solves;
    * dds, onebit and scheduling (3 rounds each) on the bit channel's
      calibration and on Bernoulli draws, analytic wire: no kernel;
    * dds and scheduling at ``LOW_POWER_DBM`` on both channels (3 rounds
      each): an accepted fraction strictly between 0 and 1, and one
      round with an erasure on the card against the CPU
      (``check_baseline_round``);
    * error_free on the packed wire (3 rounds): quantize_pack and
      spfl_accumulate once a round, and one round held against its plain
      versions on the CPU.

    The other runs take ``main_sim``'s data set.  -> the fading-jax
    solves (``time_device_solves``)."""
    import torch
    from repro_torch.configs.base import FLConfig
    from repro_torch.wire import format as fmt
    data = data_of(main_sim)
    fl = FLConfig(wire='packed', channel='bitlevel',
                  allocation_backend='jax', allocation_cadence='per_round')
    kept = []
    sim, hist, counts = run_sim(
        fl, 5, 'fading-jax', hook=lambda s: keep_device_problems(s, kept))
    check_counts('fading-jax', counts, {
        'alloc_solve': 5, 'quantize_pack': 5, 'spfl_accumulate': 5,
        'corrupt_fold': 10, 'fold_words': 10})
    traj = sim.trajectory
    if sim.host_solver_calls or torch.unique(traj, dim=0).shape[0] != 5:
        raise AssertionError('fading-jax: a host solve, or rounds with the '
                             'same gains')
    for n, st in enumerate(kept):
        if not torch.equal(st['prob'].gains, traj[n]):
            raise AssertionError(f'fading-jax round {n}: not its own gains')
    print(f'fading-jax gains (rounds x K, dB over the static gains): '
          f'{json.dumps((10 * torch.log10(traj / sim.gains_dev)).cpu().tolist())}',
          flush=True)
    print(f'fading-jax rounds 1-4: '
          f'{json.dumps([t * 1e3 for t in hist.round_time_s[1:]])} ms',
          flush=True)
    solves = time_device_solves(sim, kept, 'fading-jax')
    check_no_sync(sim, 'fading-jax', gains=traj[-1])
    check_host_problems(host_problems(sim, kept, (1, 4), 2), 2,
                        'fading-jax rounds 1 and 4\'s')

    fl_n = FLConfig(wire='packed', channel='bitlevel',
                    allocation_cadence='per_round')
    sim_n, hist_n, _ = run_sim(fl_n, 2, 'fading-numpy', data=data)
    if sim_n.host_solver_calls != 2:
        raise AssertionError(f'fading-numpy: {sim_n.host_solver_calls} '
                             'host solves in 2 rounds')

    for kind in ('dds', 'onebit', 'scheduling'):
        for channel in ('bitlevel', 'bernoulli'):
            label = f'{kind}-{channel}'
            s, h, c = run_sim(FLConfig(transport=kind, channel=channel), 3,
                              label, data=data, expect=())
            check_counts(label, c, {name: 0 for name in c})
            print(f'{label}: accepted fraction {json.dumps(h.sign_ok_frac)}'
                  f', rounds 1-2 '
                  f'{json.dumps([t * 1e3 for t in h.round_time_s[1:]])} ms',
                  flush=True)

    for kind in ('dds', 'scheduling'):
        for channel in ('bitlevel', 'bernoulli'):
            label = f'{kind}-{channel}-{LOW_POWER_DBM:g}dBm'
            s, h, c = run_sim(FLConfig(transport=kind, channel=channel,
                                       tx_power_dbm=LOW_POWER_DBM), 3,
                              label, data=data, expect=())
            check_counts(label, c, {name: 0 for name in c})
            frac = statistics.mean(h.sign_ok_frac)
            print(f'{label}: accepted fraction {json.dumps(h.sign_ok_frac)}',
                  flush=True)
            if not 0.0 < frac < 1.0:
                raise AssertionError(f'{label}: accepted fraction {frac}: '
                                     'no erasure, or nothing arrived')
            check_baseline_round(label, s)

    fl_e = FLConfig(transport='error_free', wire='packed')
    sim_e, hist_e, counts_e = run_sim(
        fl_e, 3, 'error_free', data=data,
        expect=('quantize_pack', 'spfl_accumulate'))
    check_counts('error_free', counts_e, {
        'quantize_pack': 3, 'spfl_accumulate': 3, 'corrupt_fold': 0,
        'fold_words': 0, 'alloc_solve': 0})
    want = fmt.measured_uplink_bits(sim_e.dim, fl_e.quant_bits, sim_e.K)
    if any(b != want for b in hist_e.payload_bits):
        raise AssertionError('error_free: payload_bits != measured frames')
    check_error_free_round(sim_e)
    return {'solves': solves}


# ---------------------------------------------------------------------------
# phase 8: byzantine clients, stragglers and packed-domain screening
# ---------------------------------------------------------------------------

ADV_BASE = dict(wire='packed', channel='bitlevel', allocation_backend='jax')


def honest_counts(rounds: int) -> dict:
    """The launches of ``rounds`` honest packed, bit-level 'jax' rounds."""
    return {'alloc_solve': rounds, 'quantize_pack': rounds,
            'spfl_accumulate': rounds, 'corrupt_fold': 2 * rounds,
            'fold_words': 2 * rounds}


def round_inputs(sim):
    """The gradients at ``sim``'s parameters, that round's (q, p) from
    its 'jax' solve, and fresh draws from its generators."""
    import torch
    _, grads = sim.client_grads(sim.params)
    grads = grads.detach()
    sol, _ = sim.allocate_on_device(grads, sim.gbar)
    return grads, sol.q.to(torch.float32), sol.p.to(torch.float32), sim.draw()


def screening_report(label: str, sim) -> None:
    """Per round of ``sim``'s run: the byzantine clients, the suspects
    with true and false positives, and the suspicions (findings, not
    assertions)."""
    import torch
    mask = sim.byz_mask.cpu()
    for n, rec in enumerate(sim.records):
        sus = torch.as_tensor(rec.suspect)
        print(f'{label} round {n}: byzantine '
              f'{torch.nonzero(mask).flatten().tolist()}, suspect '
              f'{torch.nonzero(sus).flatten().tolist()} (true positives '
              f'{int((sus & mask).sum())} of {int(mask.sum())}, false '
              f'positives {int((sus & ~mask).sum())}), suspicion '
              f'{json.dumps([round(float(z), 4) for z in rec.suspicion])}',
              flush=True)


def adversary_round(sim, dev, grads, q, p, draws, active=None) -> dict:
    """One packed, bit-level round of ``sim``'s adversarial knobs on
    ``dev``: step by step through the port's public functions (the forged
    frames, the received words and CRC verdicts, the majority words and
    disagreement counts, the screen), and whole (``spfl_aggregate``)."""
    from repro_torch.adversary import clients, screen
    from repro_torch.core import bitchannel, transport
    from repro_torch.wire import packets, vote
    fl = sim.fl
    g, q, p, d = grads.to(dev), q.to(dev), p.to(dev), draws_to(draws, dev)
    mask = None if sim.byz_mask is None else sim.byz_mask.to(dev)
    active = None if active is None else active.to(dev)
    n = g.shape[1]
    sw, mw, _ = transport.encode_wire(
        g, d.rand, BITS, 0,
        scaled=(mask, fl.attack_scale) if fl.attack == 'scaled' else None)
    if fl.attack == 'signflip':
        sw = clients.signflip_frames(sw, mask, n)
    rep = bitchannel.transmit_uplink(sw, mw, q, p, n=n, bits=BITS,
                                     seeds=d.seeds)
    sign_ok, mod_ok = rep.sign_ok, rep.mod_ok
    if active is not None:
        sign_ok, mod_ok = sign_ok & active, mod_ok & active
    rows = packets.sign_payload(rep.sign_words)
    maj = vote.majority_words(rows, sign_ok, n)
    dis = vote.disagreement(rows, maj, n)
    _, hdr = packets.mod_header_ranges(rep.mod_words)
    gate, suspect, suspicion = screen.screen_gate(hdr, mod_ok, dis, n,
                                                  sign_ok, fl.screen_z)
    ghat, rec = transport.spfl_aggregate(
        g, sim.gbar.to(dev), q, p, BITS, fl.b0_bits, d, wire=fl.wire,
        channel=fl.channel, attack=fl.attack, byz_mask=mask,
        attack_scale=fl.attack_scale, active=active, screen=fl.screen,
        screen_z=fl.screen_z)
    out = {'forged sign words': sw, 'mod words': mw,
           'received sign words': rep.sign_words,
           'received mod words': rep.mod_words,
           'sign CRC': rep.sign_crc_ok, 'mod CRC': rep.mod_crc_ok,
           'sign flips': rep.sign_flips, 'mod flips': rep.mod_flips,
           'majority words': maj, 'disagreement': dis, 'gate': gate,
           'suspect': suspect, 'transport suspect': rec.suspect,
           'sign_ok': rec.sign_ok, 'mod_ok': rec.mod_ok}
    if rec.sign_votes is not None:
        out['sign votes'] = rec.sign_votes
    out = {name: t.cpu() for name, t in out.items()}
    out.update(suspicion=suspicion.cpu(), transport_suspicion=
               rec.suspicion.cpu(), ghat=ghat.cpu(), header=hdr.cpu(),
               weight=(rec.sign_ok.to(q.dtype) / q).cpu())
    return out


def suspicion_atol(g_max) -> float:
    """4 ulp of the largest |log g_max| over the norm MAD floor: the
    suspicion near the median is a difference of two f32 logs, whose
    last bit the card's and the CPU's log may round apart."""
    import torch
    from repro_torch.adversary import screen
    logr = torch.log(torch.clamp(g_max.double(), min=1e-30)).abs().max()
    return (4 * float(torch.finfo(torch.float32).eps) * float(logr)
            / screen.NORM_MAD_FLOOR)


def check_adversary_round(label: str, sim, active=None) -> None:
    """One round of ``sim``'s knobs on the card against the same round
    through the plain versions on the CPU, with the same gradients,
    draws, (q, p), byzantine mask and ``active``: every word, CRC
    verdict, majority word, disagreement count, gate and suspect bit for
    bit; the transport's own suspects equal the step-by-step ones on each
    side; suspicion within 4 ulp of the log range over the MAD floor
    (plus 4 ulp of itself); ĝ within the FMA-wobble bound."""
    import torch
    grads, q, p, draws = round_inputs(sim)
    gpu = adversary_round(sim, 'cuda', grads, q, p, draws, active)
    cpu = adversary_round(sim, 'cpu', grads, q, p, draws, active)
    n_words = 0
    for name, a in gpu.items():
        if name in ('suspicion', 'transport_suspicion', 'ghat', 'header',
                    'weight'):
            continue
        if not torch.equal(a, cpu[name]):
            raise AssertionError(f'{label} {name}: card != CPU')
        if 'words' in name:
            n_words += a.numel()
    for side in (gpu, cpu):
        if not torch.equal(side['suspect'], side['transport suspect']):
            raise AssertionError(f'{label}: the transport\'s suspects != '
                                 'the step-by-step ones')
        if not torch.equal(side['suspicion'], side['transport_suspicion']):
            raise AssertionError(f'{label}: the transport\'s suspicion != '
                                 'the step-by-step one')
    s_err = float((gpu['suspicion'] - cpu['suspicion']).abs().max())
    s_tol = (suspicion_atol(gpu['header'])
             + 4 * float(torch.finfo(torch.float32).eps)
             * float(gpu['suspicion'].abs().max()))
    if s_err > s_tol:
        raise AssertionError(f'{label} suspicion: card - CPU {s_err} > '
                             f'{s_tol}')
    present = gpu['sign_ok'].new_ones(gpu['sign_ok'].shape)
    if active is not None:
        present &= active.cpu()
    present &= ~gpu['suspect']
    weight = gpu['weight'] * gpu['gate']
    tol = ulp_atol(weight, gpu['header'], sim.gbar.cpu()) / max(
        int(present.sum()), 1)
    err = float((gpu['ghat'] - cpu['ghat']).abs().max())
    if err > tol:
        raise AssertionError(f'{label} ghat: card - CPU {err} > {tol}')
    print(f'{label} round: card vs CPU plain versions: {n_words} words, '
          'CRC verdicts, majority words, disagreement counts '
          f'{gpu["disagreement"].tolist()}, gate and suspect '
          f'{torch.nonzero(gpu["suspect"]).flatten().tolist()} bit for bit; '
          f'suspicion max |diff| {s_err:.3e} (bound {s_tol:.3e}), ghat max '
          f'|diff| {err:.3e} (bound {tol:.3e})', flush=True)


def check_dropped_rows(sim) -> None:
    """A dropped client is a no-op on the card: with every fourth client
    (from the second) inactive, replacing their gradients by ±1e6 leaves
    ĝ bit for bit."""
    import torch
    from repro_torch.core import transport
    grads, q, p, draws = round_inputs(sim)
    k = grads.shape[0]
    active = torch.arange(k, device=grads.device) % 4 != 1
    dropped = torch.nonzero(~active).flatten()
    bad = grads.clone()
    bad[dropped] = 1e6
    bad[dropped[::2]] = -1e6
    out = []
    for g in (grads, bad):
        ghat, rec = transport.spfl_aggregate(
            g, sim.gbar, q, p, BITS, sim.fl.b0_bits, draws, wire='packed',
            channel='bitlevel', active=active)
        out.append((ghat, rec))
    if not torch.equal(out[0][0], out[1][0]):
        raise AssertionError('dropout: a dropped row changed ghat')
    if bool((out[0][1].sign_ok | out[0][1].mod_ok)[~active].any()):
        raise AssertionError('dropout: a dropped row was accepted')
    print(f'dropout: {int((~active).sum())} dropped rows set to ±1e6: ghat '
          'bit for bit on the card', flush=True)


def check_benign_screen(sim, tries: int = 3) -> None:
    """With the same gradients and draws, a screened round of ``sim``
    (no attacker) equals the unscreened one bit for bit on the card:
    ĝ and every telemetry integer.  That holds where the screen flags no
    honest client; a round where it does (a false positive, printed) is
    followed by another round of ``sim``, up to ``tries`` rounds."""
    import torch
    from repro_torch.core import transport
    for _ in range(tries):
        grads, q, p, draws = round_inputs(sim)
        out = [transport.spfl_aggregate(grads, sim.gbar, q, p, BITS,
                                        sim.fl.b0_bits, draws, wire='packed',
                                        channel='bitlevel', screen=screen)
               for screen in (False, True)]
        (g0, r0), (g1, r1) = out
        if not bool(r1.suspect.any()):
            break
        print(f'benign screen: honest clients '
              f'{torch.nonzero(r1.suspect).flatten().tolist()} flagged '
              f'(suspicion {json.dumps(r1.suspicion.tolist())}); next round',
              flush=True)
        sim.round_step()
    else:
        raise AssertionError(f'benign screen: an honest client flagged in '
                             f'each of {tries} rounds')
    if not torch.equal(g0, g1):
        raise AssertionError('benign screen: ghat changed')
    for name, val in r0._asdict().items():
        if val is not None and not torch.equal(val, getattr(r1, name)):
            raise AssertionError(f'benign screen: {name} changed')
    print('benign screen: screened == unscreened round bit for bit on the '
          f'card (ghat and {sum(v is not None for v in r0)} telemetry '
          f'fields; suspicion max {float(r1.suspicion.max()):.4f})',
          flush=True)


def screen_cost(screened, plain, tries: int = 3) -> dict:
    """One more round of each of ``screened`` and ``plain`` (the same
    configuration with and without ``screen``) under ``torch.profiler``:
    the ``round/screen`` span's host and device ms, the device operations
    inside its device span, and each round's device operations (their
    difference is what screening adds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cpu = torch.autograd.DeviceType.CPU
    out = {}
    for label, sim in (('screened', screened), ('plain', plain)):
        for _ in range(tries):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                sim.run(1)
                torch.cuda.synchronize()
            host = dev_span = None
            ops = []
            for e in prof.events():
                if e.name == 'round/screen':
                    if e.device_type == cpu:
                        host = e.time_range
                    else:
                        dev_span = e.time_range
                elif e.device_type != cpu and not e.name.startswith('round/'):
                    ops.append(e.time_range)
            if ops:
                break
        r = {'device_ops': len(ops)}
        if host is not None:
            r['host_ms'] = (host.end - host.start) / 1e3
        if dev_span is not None:
            r['device_ms'] = (dev_span.end - dev_span.start) / 1e3
            r['span_ops'] = sum(1 for t in ops if t.start >= dev_span.start
                                and t.end <= dev_span.end)
        out[label] = r
    if not out['plain']['device_ops'] or 'host_ms' not in out['screened']:
        raise AssertionError(f'screen cost: the profiler recorded {out}')
    out['added_ops'] = (out['screened']['device_ops']
                        - out['plain']['device_ops'])
    print(f'screen cost (torch.profiler, one round each): round/screen host '
          f'{out["screened"]["host_ms"]:.3f} ms, device '
          f'{out["screened"].get("device_ms", float("nan")):.3f} ms, '
          f'{out["screened"].get("span_ops", "no device span")} device '
          f'operations in its span; device operations a round '
          f'{out["screened"]["device_ops"]} screened vs '
          f'{out["plain"]["device_ops"]} plain: screening adds '
          f'{out["added_ops"]}', flush=True)
    return out


def run_adversary(main_sim, main_jax, jax_times) -> dict:
    """Phase 8 at full width on ``main_sim``'s data, every run
    ``FLConfig(wire='packed', channel='bitlevel',
    allocation_backend='jax', ...)`` with the launch counters reset just
    before and read just after (``run_sim``):

    * signflip and scaled (``attack_scale`` 10) with ``screen=True``, 3
      rounds each: an honest run's launches exactly; per round the
      byzantine mask, suspects and suspicions; one round on the card
      against the CPU (``check_adversary_round``);
    * dropout (``dropout_rate`` 0.25), 5 rounds: the participation per
      round; a dropped row is a no-op on the card
      (``check_dropped_rows``);
    * benign screen (``screen=True``, no attacker), 3 rounds: the same
      launches; the screened round equals the unscreened one bit for bit
      (``check_benign_screen``);
    * labelflip, 2 rounds: the flipped rows are exactly the mask's;
    * the cost of screening (``screen_cost``: the benign-screen run
      against ``main_jax``, phase 4's run of the same configuration
      unscreened), and every run's round times beside main-jax's
      (``jax_times``)."""
    import torch
    from repro_torch.configs.base import FLConfig
    data = data_of(main_sim)
    times = {'main-jax': jax_times}
    sims = {}
    for attack in ('signflip', 'scaled'):
        fl = FLConfig(**ADV_BASE, attack=attack, screen=True,
                      attack_scale=10.0)
        sim, hist, counts = run_sim(fl, 3, attack, data=data)
        check_counts(attack, counts, honest_counts(3))
        screening_report(attack, sim)
        print(f'{attack}: suspect_frac {json.dumps(hist.suspect_frac)}',
              flush=True)
        check_adversary_round(attack, sim)
        times[attack] = hist.round_time_s[1:]
        sims[attack] = sim

    fl = FLConfig(**ADV_BASE, dropout_rate=0.25)
    sim, hist, counts = run_sim(fl, 5, 'dropout', data=data)
    check_counts('dropout', counts, honest_counts(5))
    print(f'dropout: participation_frac {json.dumps(hist.participation_frac)}',
          flush=True)
    if not all(0.0 < f <= 1.0 for f in hist.participation_frac):
        raise AssertionError('dropout: a round with no client present')
    check_dropped_rows(sim)
    times['dropout'] = hist.round_time_s[1:]

    fl = FLConfig(**ADV_BASE, screen=True)
    benign, hist, counts = run_sim(fl, 3, 'benign-screen', data=data)
    check_counts('benign-screen', counts, honest_counts(3))
    print(f'benign-screen: suspect_frac {json.dumps(hist.suspect_frac)} '
          '(no attacker: any suspect is a false positive)', flush=True)
    check_benign_screen(benign)
    times['benign-screen'] = hist.round_time_s[1:]

    fl = FLConfig(**ADV_BASE, attack='labelflip')
    sim, hist, counts = run_sim(fl, 2, 'labelflip', data=data)
    check_counts('labelflip', counts, honest_counts(2))
    changed = (sim.client_y.cpu() != torch.as_tensor(data[1])).any(dim=1)
    if not torch.equal(changed, sim.byz_mask.cpu()):
        raise AssertionError(f'labelflip: rows {changed.tolist()} flipped, '
                             f'mask {sim.byz_mask.tolist()}')
    print(f'labelflip: rows {torch.nonzero(changed).flatten().tolist()} '
          'flipped, exactly the byzantine mask', flush=True)
    times['labelflip'] = hist.round_time_s[1:]

    cost = screen_cost(benign, main_jax)
    print(card_line(), flush=True)
    for label, ts in times.items():
        print(f'{label} rounds after round 0: '
              f'{json.dumps([t * 1e3 for t in ts])} ms', flush=True)
    return {'times': times, 'cost': cost}


# ---------------------------------------------------------------------------
# phase 9: population cohorts and the telemetry ring
# ---------------------------------------------------------------------------

# rounds 0-2's cohort ids of seed 0, N = 10^6, K = 20, uniform sampler:
# the reference's round-key chain (tests/test_torch_population.py pins
# them to repro.population.sample_cohort)
POP_UNIFORM_IDS = (
    [94950, 387061, 830397, 302548, 109883, 395597, 29134, 509173, 790854,
     1563, 208606, 655196, 209918, 43836, 126708, 533612, 627030, 648454,
     192717, 539654],
    [446703, 741483, 149716, 554167, 64939, 87676, 423135, 621059, 554093,
     652032, 95198, 198103, 391446, 773209, 605999, 69867, 307927, 728881,
     582594, 737683],
    [367924, 847855, 893816, 64298, 992820, 184554, 177273, 902357, 359666,
     723776, 858771, 613564, 447479, 135749, 647170, 563512, 563283, 261761,
     277545, 733544],
)


POP_BASE = dict(wire='packed', channel='bitlevel', allocation_backend='jax',
                population_n=10 ** 6, cohort_size=K, population_shards=64)
# label, knobs, rounds: N = 10^6 uniform (per-round shadowing, telemetry
# on), N = 10^6 availability, and N = K availability, whose 20 candidates
# at a mean availability of 0.65 leave ~7 rows a round absent (ragged)
POP_RUNS = (
    ('pop-uniform', dict(cohort_sampler='uniform',
                         allocation_cadence='per_round'), 5),
    ('pop-availability', dict(cohort_sampler='availability'), 3),
    ('pop-ragged', dict(cohort_sampler='availability', population_n=K), 3),
)


def population_round(sim, dev, grads, q, p, draws, active) -> dict:
    """One packed, bit-level round of ``sim``'s cohort on ``dev``: the
    framed words, the received words and CRC verdicts, and the whole
    transport (``spfl_aggregate`` with the cohort's ``active``) -> host
    tensors."""
    from repro_torch.core import bitchannel, transport
    fl = sim.fl
    g, q, p, d = grads.to(dev), q.to(dev), p.to(dev), draws_to(draws, dev)
    active = None if active is None else active.to(dev)
    n = g.shape[1]
    sw, mw, _ = transport.encode_wire(g, d.rand, BITS, 0)
    rep = bitchannel.transmit_uplink(sw, mw, q, p, n=n, bits=BITS,
                                     seeds=d.seeds)
    ghat, rec = transport.spfl_aggregate(
        g, sim.gbar.to(dev), q, p, BITS, fl.b0_bits, d, wire=fl.wire,
        channel=fl.channel, active=active)
    out = {'sign words': sw, 'mod words': mw,
           'received sign words': rep.sign_words,
           'received mod words': rep.mod_words, 'sign CRC': rep.sign_crc_ok,
           'mod CRC': rep.mod_crc_ok, 'sign_ok': rec.sign_ok,
           'mod_ok': rec.mod_ok, 'ghat': ghat}
    if rec.active is not None:
        out['active'] = rec.active
    if rec.sign_votes is not None:
        out['sign votes'] = rec.sign_votes
    return {name: t.cpu() for name, t in out.items()}


def check_population_round(label: str, sim) -> None:
    """The next cohort of ``sim``'s key chain, one round on the card
    against the same round through the plain versions on the CPU, with
    the same cohort, gains, gradients, (q, p) and draws: the one copy
    carries the host draw exactly; every word, CRC verdict, ``active``
    and ĝ bit for bit."""
    import torch
    draw = sim.draw_cohort()
    crd = sim.cohort_to_device(draw)
    carried = (torch.equal(crd.ids.cpu(), draw.cohort.ids)
               and torch.equal(crd.p_w.cpu(), draw.cohort.p_w.double())
               and torch.equal(crd.gains.cpu(), draw.gains.double()))
    if not carried:
        raise AssertionError(f'{label}: the cohort on the card != the '
                             'host draw')
    _, grads = sim.client_grads(sim.params, crd)
    grads = grads.detach()
    sol, _ = sim.allocate_on_device(grads, sim.gbar, crd.gains, crd.p_w)
    q, p = sol.q.to(torch.float32), sol.p.to(torch.float32)
    draws = sim.draw()
    gpu = population_round(sim, 'cuda', grads, q, p, draws, crd.present)
    cpu = population_round(sim, 'cpu', grads, q, p, draws, crd.present)
    for name, a in gpu.items():
        if not torch.equal(a, cpu[name]):
            raise AssertionError(f'{label} {name}: card != CPU')
    n_words = sum(a.numel() for name, a in gpu.items() if 'words' in name)
    absent = 0 if crd.present is None else int((~crd.present).sum())
    print(f'{label} round: card vs CPU plain versions: {n_words} words, '
          f'CRC verdicts, active ({absent} absent), sign_ok '
          f'{int(gpu["sign_ok"].sum())} of {K} and ghat bit for bit',
          flush=True)


def check_population_no_sync(sim) -> None:
    """A population round queues its work without a host synchronization
    (``torch.cuda.set_sync_debug_mode('error')``): the cohort draw on the
    host, its one copy to the card, the gather of the cohort's shards,
    the gradients, the stats, the solve and the casts; then a round's
    condensed record pushed into a telemetry ring (a non-flush round's
    only telemetry work)."""
    import torch
    from repro_torch.obs import ringbuf
    res = sim.round_step()
    ring = ringbuf.ring_init(res.telemetry.condensed(), 8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        crd = sim.cohort_to_device(sim.draw_cohort())
        _, grads = sim.client_grads(sim.params, crd)
        sol, _ = sim.allocate_on_device(grads, sim.gbar, crd.gains, crd.p_w)
        sol.q.to(torch.float32), sol.p.to(torch.float32)
        ringbuf.ring_push(ring, res.telemetry.condensed())
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    print('pop-uniform: from the cohort draw to (q, p), and the ring push, '
          "nothing waits for the card (sync debug mode 'error')",
          flush=True)


def _same_value(a, b) -> bool:
    return (a == b) or (a is not None and b is not None
                        and math.isnan(a) and math.isnan(b))


def check_telemetry(path: str, sim, hist, rounds: int) -> None:
    """The JSONL of a run with ``telemetry_path``: a manifest, one row per
    round with its cohort ids (the run's records'), then spans and
    metrics; every row's scalars equal the run's ``FLHistory`` lists."""
    from repro_torch.obs import record, sink
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    types = [line['type'] for line in lines]
    want = ['manifest'] + ['round'] * rounds + ['spans', 'metrics']
    if types != want:
        raise AssertionError(f'telemetry lines {types}, want {want}')
    _, rows = sink.read_jsonl(path)
    for key in record.SCALAR_KEYS:
        got = [row[key] for row in rows]
        ref = getattr(hist, key)
        if not ref:                 # a list the run keeps only when set
            ref = [math.nan] * rounds
        if len(got) != len(ref) or not all(
                _same_value(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f'telemetry {key} {got} != history {ref}')
    for row, rec in zip(rows, sim.records):
        if row['cohort_ids'] != rec.cohort_ids.tolist():
            raise AssertionError('telemetry cohort_ids != the records\'')
    spans = lines[-2]['spans']
    print(f'pop-uniform telemetry: {len(lines)} lines (manifest, '
          f'{rounds} rounds with cohort_ids, spans, metrics), rows = the '
          f'history; spans {json.dumps(spans)}', flush=True)


def run_population(main_jax_times) -> dict:
    """Phase 9 at full width (``POP_RUNS``, ``build_simulator`` with
    ``population_shards`` 64 of 500 images, K=20, 3 bits, packed,
    bit-level, 'jax' backend), each run with the launch counters reset
    just before and read just after (``run_sim``): exactly main-jax's
    launches; the cohort ids distinct and in [0, N) (pop-uniform's rounds
    0-2 the pinned ``POP_UNIFORM_IDS``); ``participation_frac``; each
    solve timed alone with its trips and whether it kept to the spine;
    one round on the card against the CPU bit for bit
    (``check_population_round``); the ``round/cohort`` span under the
    profiler (``round_split``); pop-uniform with ``telemetry_path`` set
    (``check_telemetry``, ``check_population_no_sync``).  -> round times
    and the solves."""
    import tempfile
    from repro_torch.configs.base import FLConfig
    times = {'main-jax': main_jax_times}
    solves, data = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for label, knobs, rounds in POP_RUNS:
            path = f'{tmp}/telemetry.jsonl' if label == 'pop-uniform' else None
            fl = FLConfig(**{**POP_BASE, **knobs, 'telemetry_path': path})
            kept = []
            sim, hist, counts = run_sim(
                fl, rounds, label, data=data,
                hook=lambda s: keep_device_problems(s, kept))
            data = data_of(sim) if data is None else data
            check_counts(label, counts, honest_counts(rounds))
            ids = [rec.cohort_ids.tolist() for rec in sim.records]
            for n, row in enumerate(ids):
                if len(set(row)) != K or not all(
                        0 <= i < fl.population_n for i in row):
                    raise AssertionError(f'{label} round {n}: cohort {row}')
            print(f'{label}: cohort ids of round 0 {json.dumps(ids[0])}; '
                  f'participation_frac {json.dumps(hist.participation_frac)}',
                  flush=True)
            if label == 'pop-uniform':
                if ids[:3] != [list(r) for r in POP_UNIFORM_IDS]:
                    raise AssertionError('pop-uniform: rounds 0-2 are not '
                                         'the pinned cohorts')
                print('pop-uniform: rounds 0-2 are the pinned cohorts of the '
                      "reference's key chain", flush=True)
                check_telemetry(path, sim, hist, rounds)
            elif label == 'pop-ragged' and all(
                    f == 1.0 for f in hist.participation_frac):
                raise AssertionError('pop-ragged: no absent row in any round')
            solves[label] = time_device_solves(sim, kept, label)
            check_population_round(label, sim)
            round_split(sim, label=label,
                        spans=('round/cohort',) + ROUND_SPANS)
            if label == 'pop-uniform':
                check_population_no_sync(sim)
            times[label] = hist.round_time_s[1:]
    print(card_line(), flush=True)
    for label, ts in times.items():
        print(f'{label} rounds after round 0: '
              f'{json.dumps([t * 1e3 for t in ts])} ms', flush=True)
    return {'times': times, 'solves': solves}


# ---------------------------------------------------------------------------
# phase 10: fused rounds (round_fusion 'eager' and 'scan') as CUDA graphs
# ---------------------------------------------------------------------------

# main-jax in segments of 4 rounds: two whole segments and a ragged tail
FUSED_BASE = dict(wire='packed', channel='bitlevel', allocation_backend='jax',
                  telemetry_flush_every=4)
FUSED_ROUNDS = 10
# every other knob of the host loop, fused ('scan', 3 rounds in segments
# of 2 and 1: two captures; retx also 'eager'): label, FLConfig knobs over
# FUSED_BASE, the kernels the run must launch (None: the round kernels)
FUSED_SWEEP = (
    ('retx', dict(transport='spfl_retx', allocator='uniform',
                  tx_power_dbm=-40.0), None),
    ('bernoulli', dict(channel='bernoulli'), ['quantize_pack',
                                              'spfl_accumulate']),
    ('analytic', dict(wire='analytic', channel='bernoulli'), []),
    ('last_local', dict(compensation='last_local'), None),
    ('seeded_random', dict(compensation='seeded_random'), None),
    ('zeros', dict(compensation='zeros'), None),
    ('per_round', dict(allocation_cadence='per_round'), None),
    ('barrier', dict(allocator='barrier', allocation_max_iters=1), None),
    ('scaled-screen', dict(attack='scaled', screen=True), None),
    ('dropout', dict(dropout_rate=0.25, min_participation=0.5), None),
    ('labelflip', dict(attack='labelflip'), None),
    ('dds', dict(transport='dds'), []),
    ('onebit', dict(transport='onebit', channel='bernoulli',
                    wire='analytic'), []),
    ('scheduling', dict(transport='scheduling'), []),
    ('error_free-analytic', dict(transport='error_free', wire='analytic'),
     []),
)
# the f32 contract against the float64 solve (tests/test_torch_allocation_
# jax_f32.py, the reference's "f32 solve_traceable contract")
F32_CONTRACT = dict(obj_rtol=1e-4, qp_atol=5e-3)


def same_solution(got, want, label: str) -> None:
    """Two JaxAllocations equal bit for bit (NaN where NaN), or raise
    naming the outputs that differ and by how much."""
    import torch
    differ = {}
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if not torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)):
            differ[f] = float((a.double() - b.double()).abs()
                              .nan_to_num(0.0).max())
    if differ:
        raise AssertionError(f'{label}: not bit for bit: {differ}')


def check_alloc_f32(seed: int) -> dict:
    """The float32 solver kernel (``alloc_solve_f32``) on the card: (i)
    against its plain version on the same card tensors, bit for bit: the
    CPU tests' parity grid (K in {4, 8} x 4 powers) and a K=20 problem as
    one float32 batch, alternating at max_iters=2 with a gate of 0 on
    every third problem (the round-0 guard: the uniform point) and
    barrier at max_iters=1; (ii) the alternating solves within the f32
    contract of the float64 kernel on the same problems (objective rtol
    1e-4, q/p atol 5e-3).  -> {'plain_s'}."""
    import torch
    from repro_torch.core import allocation_jax as AJ
    from repro_torch.kernels import ops
    probs = [alloc_problem(k, p, 10 * k + int(-p)) for k in (4, 8)
             for p in ALLOC_POWERS] + [alloc_problem(20, -14.0, seed)]
    ks = [p.n for p in probs]
    batch = AJ.stack_problems(probs, dtype=torch.float32, device='cuda')
    gate = torch.ones(len(probs), dtype=torch.float32, device='cuda')
    gate[::3] = 0.0
    out = {'plain_s': {}}
    for method, iters, g in (('alternating', 2, gate),
                             ('barrier', 1, None)):
        ops.reset_launch_counts()
        kern = ops.alloc_solve(batch, method, max_iters=iters, gate=g)
        torch.cuda.synchronize()
        if ops.launch_counts['alloc_solve_f32'] != 1:
            raise AssertionError('a float32 problem did not launch '
                                 'alloc_solve_f32')
        t0 = time.perf_counter()
        plain = AJ.solve_plain(batch, method, max_iters=iters, gate=g)
        torch.cuda.synchronize()
        out['plain_s'][method] = time.perf_counter() - t0
        same_solution(kern, plain, f'alloc_solve_f32 {method}')
        print(f'alloc_solve_f32 {method}: kernel vs plain (plain '
              f'{out["plain_s"][method]:.1f} s): {len(ks)} problems bit '
              'for bit', flush=True)
    wide = ops.alloc_solve(AJ.stack_problems(probs, device='cuda'),
                           'alternating', max_iters=2,
                           gate=gate.double())
    narrow = ops.alloc_solve(batch, 'alternating', max_iters=2, gate=gate)
    worst = {}
    for i, (a, b) in enumerate(zip(alloc_rows(narrow, ks),
                                   alloc_rows(wide, ks))):
        obj = float(b['objective'])
        rel = abs(float(a['objective']) - obj) / max(abs(obj), 1e-30)
        qp = max(float((a[f].double() - b[f]).abs().max())
                 for f in ('q', 'p'))
        worst['obj_rel'] = max(worst.get('obj_rel', 0.0), rel)
        worst['qp_abs'] = max(worst.get('qp_abs', 0.0), qp)
        if rel > F32_CONTRACT['obj_rtol'] or qp > F32_CONTRACT['qp_atol']:
            raise AssertionError(f'alloc_solve_f32 problem {i}: outside the '
                                 f'f32 contract of the f64 kernel: {rel} '
                                 f'{qp}')
    print(f'alloc_solve_f32 vs alloc_solve (float64), alternating: within '
          f'the f32 contract {json.dumps(F32_CONTRACT)}, worst '
          f'{json.dumps(worst)}; layout (K=20) '
          f'{json.dumps(ops.alloc_layout(1, K, "alternating", torch.float32))}'
          f' (float64 {json.dumps(ops.alloc_layout(1, K))})', flush=True)
    return out


def keep_f32_problems(sim, kept: list) -> None:
    """Run ``sim``'s host loop with the fused round's float32 solve as its
    step 2 (``_solve_f32``: the same (q, p) as a fused run's, so its
    records are the fused run's) and keep each round's float32 problem
    and stats as ``keep_device_problems`` keeps the float64 ones."""
    def solve(grads, gains, p_w=None):
        out = sim._solve_f32(grads, gains, p_w)
        kept.append({'prob': out[1]['prob'], 'gb2': out[1]['gb2']})
        return out
    sim._solve = solve


def check_gradient_repeats(sim, passes: int = 6) -> dict:
    """Whether ``passes`` gradient passes of ``sim`` at the same
    parameters give the same bits, under cuDNN's default algorithms and
    under deterministic ones (``sim.deterministic``, which fused rounds
    need: raises if those differ).  -> {False: bool, True: bool}."""
    import torch
    was, out = sim.deterministic, {}
    try:
        for det in (False, True):
            sim.deterministic = det
            first = sim.client_grads(sim.params)[1].clone()
            out[det] = all(torch.equal(first,
                                       sim.client_grads(sim.params)[1])
                           for _ in range(passes - 1))
    finally:
        sim.deterministic = was
    print(f'{passes} gradient passes at the same parameters bit for bit: '
          f'default cuDNN {out[False]}, deterministic cuDNN {out[True]}',
          flush=True)
    if not out[True]:
        raise AssertionError('deterministic cuDNN gradients differ')
    return out


def same_runs(a, b, label: str, skip=()) -> None:
    """Two simulators' parameters, ḡ and every record field bit for bit."""
    import numpy as np
    import torch
    if not (torch.equal(a.params, b.params) and torch.equal(a.gbar, b.gbar)):
        raise AssertionError(f'{label}: parameters or ḡ differ')
    if len(a.records) != len(b.records):
        raise AssertionError(f'{label}: {len(a.records)} != '
                             f'{len(b.records)} records')
    for n, (ra, rb) in enumerate(zip(a.records, b.records)):
        for f in ra._fields:
            x, y = getattr(ra, f), getattr(rb, f)
            if f in skip or (x is None and y is None):
                continue
            if (x is None) != (y is None) or not np.array_equal(
                    np.asarray(x), np.asarray(y), equal_nan=True):
                raise AssertionError(f'{label}: round {n} {f} differs')
    print(f'{label}: parameters, ḡ and every record field of '
          f'{len(a.records)} rounds bit for bit', flush=True)


def busy_ms(spans) -> float:
    """The union of (start, end) device intervals (µs) in ms: time the
    card was busy with at least one operation."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


class Watch:
    """A simulator's ``segment_guard``: each segment launch under
    ``torch.cuda.set_sync_debug_mode('error')`` ('sync'), or under
    ``torch.profiler`` until the card is done ('profile': device
    operations by name, the ms of each kind, the card's busy ms (the
    union of their intervals) and the launch's wall ms)."""

    def __init__(self, mode: str):
        self.mode = mode
        self.launches = []

    def __call__(self):
        import contextlib
        import torch
        from torch.profiler import ProfilerActivity, profile

        @contextlib.contextmanager
        def guard():
            if self.mode == 'sync':
                torch.cuda.set_sync_debug_mode('error')
                try:
                    yield
                finally:
                    torch.cuda.set_sync_debug_mode('default')
                self.launches.append({})
                return
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                yield
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            names, spans, ms = {}, [], {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    names[e.name] = names.get(e.name, 0) + 1
                    spans.append((e.time_range.start, e.time_range.end))
                    key = e.name.split('(')[0].split('<')[0][-48:]
                    ms[key] = ms.get(key, 0.0) + (
                        e.time_range.end - e.time_range.start) / 1e3
            top = dict(sorted(ms.items(), key=lambda kv: -kv[1])[:8])
            self.launches.append({'names': names, 'busy_ms': busy_ms(spans),
                                  'sum_ms': sum(ms.values()),
                                  'top_ms': top, 'wall_ms': wall})
        return guard()


def op_kinds(names: dict) -> dict:
    """Device operations by kind: the port's kernels by name, copies by
    direction, the rest counted together."""
    out = {}
    for name, n in names.items():
        if 'Memcpy' in name or 'Memset' in name:
            key = name.split(' (')[0]
        elif 'alloc_solve_kernel' in name:
            key = ('alloc_solve_f32' if 'alloc_solve_kernel<float>' in name
                   else 'alloc_solve')
        else:
            key = next((k for k in kernels_on('round')
                        if f'{k}_kernel' in name), 'other')
        out[key] = out.get(key, 0) + n
    return out


def run_fused(data) -> dict:
    """Phase 10: fused rounds at full width (K=20, 500 images a client,
    the paper's CNN, packed, bit-level, 'jax'): the float32 solver kernel
    (``check_alloc_f32``); main-jax for 2 segments of 4 rounds and a
    ragged tail of 2 under 'eager', 'scan' and the host loop, each with
    the counters reset just before and read just after ('scan' = 'eager'
    bit for bit; the fused runs under ``torch.profiler``: each kernel's
    count in the card's record is exact, and the wrappers issued what the
    warm-up and the captures hold); the host loop handed the float32 solve
    (``keep_f32_problems``, deterministic cuDNN) = 'scan' bit for bit,
    each of its solves timed alone (``time_device_solves``); gradient
    passes' bits under both cuDNN modes (``check_gradient_repeats``);
    the round times of a second run of each dispatch and of the host loop
    under deterministic cuDNN (the graphs kept: every segment steady); fused
    error_free = the host loop's (deterministic cuDNN) bit for bit; one
    population cell (pop-uniform, 3 rounds) fused; a whole 'scan' segment
    and an 'eager' replay under ``set_sync_debug_mode('error')``; the
    device operations of one replayed round and one segment's idle share
    (``torch.profiler``); the last round's f32 solve held to its plain
    version bit for bit.  -> the row of the f32 solver, the round times
    and the solves."""
    import dataclasses
    import torch
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import allocation_jax as AJ
    from repro_torch.kernels import ops
    alloc = check_alloc_f32(seed=15)
    fl = FLConfig(**FUSED_BASE)
    rounds = FUSED_ROUNDS
    seg = fl.telemetry_flush_every

    def per_round(n):
        """Each main-path kernel's launches in n rounds."""
        return {'alloc_solve_f32': n, 'quantize_pack': n,
                'spfl_accumulate': n, 'corrupt_fold': 2 * n,
                'fold_words': 2 * n, 'alloc_solve': 0}
    # the card runs the warm-up round and every round; the wrappers issue
    # the warm-up round and each capture ('scan': one graph a segment
    # length, 'eager': one round)
    issued = {'scan': 1 + seg + rounds % seg, 'eager': 2}
    runs, ran = {}, {}
    for mode in ('none', 'eager', 'scan'):
        fused = mode != 'none'
        ran[mode] = {} if fused else None
        runs[mode] = run_sim(
            dataclasses.replace(fl, round_fusion=mode), rounds,
            f'fused-{mode}', data=data, ran=ran[mode],
            expect=kernels_on('round') + ['alloc_solve_f32' if fused
                                          else 'alloc_solve'])
        if fused:
            check_counts(f'fused-{mode} on the card', ran[mode],
                         per_round(rounds + 1))
            check_counts(f'fused-{mode} issued', runs[mode][2],
                         per_round(issued[mode]))
    same_runs(runs['eager'][0], runs['scan'][0], "fused 'scan' vs 'eager'")
    check_gradient_repeats(runs['none'][0])
    # the host loop with the fused round's float32 solve and deterministic
    # cuDNN: the fused run's rounds exactly, and its problems to time
    kept = []

    def twin(sim):
        sim.deterministic = True
        keep_f32_problems(sim, kept)
    host_f32 = run_sim(fl, rounds, 'host-f32', data=data, hook=twin,
                       expect=kernels_on('round') + ['alloc_solve_f32'])[0]
    same_runs(host_f32, runs['scan'][0],
              "fused 'scan' vs the host loop given its float32 (q, p)",
              skip=('round_idx',))
    solves = time_device_solves(host_f32, kept, 'fused-f32')
    # round 1's float32 problem, exactly, and what the kernel made of it:
    # the CPU tests hold the port's dual search on it to the reference's
    one = solves[1]
    record = {f: getattr(one['prob'], f).tolist()
              for f in one['prob']._fields
              if getattr(one['prob'], f) is not None}
    record.update(method=fl.allocator, max_iters=fl.allocation_max_iters
                  or 6, iters=one['iters'], exit_reason=one['exit_reason'],
                  trips=dict(zip(ops.ALLOC_TRIPS, one['trips'])))
    print(f'fused-f32 round 1 problem: {json.dumps(record)}', flush=True)
    # what deterministic cuDNN costs the host loop (the fused rounds' one)
    det = run_sim(fl, rounds, 'host-deterministic', data=data,
                  hook=lambda sim: setattr(sim, 'deterministic', True))[0]
    for mode in ('none', 'scan'):
        h = runs[mode][1]
        print(f'fused-{mode}: alloc_exit_reason {json.dumps(h.alloc_exit_reason)}'
              f', alloc_iters {json.dumps(h.alloc_iters)}, q_mean '
              f'{json.dumps(h.q_mean)}, p_mean {json.dumps(h.p_mean)}',
              flush=True)
    # round times: a second run of each, unprofiled, whose fused segments
    # replay the graphs the first run captured
    times = {}
    for label, sim in (('host', runs['none'][0]), ('host-deterministic', det),
                       ('fused-eager', runs['eager'][0]),
                       ('fused-scan', runs['scan'][0])):
        ts = sim.run(rounds).round_time_s
        times[label] = ts
        print(f'{label} second run round times '
              f'{json.dumps([t * 1e3 for t in ts])} ms; mean '
              f'{sum(ts) / len(ts) * 1e3:.3f} ms', flush=True)
    # error_free: nothing solved, so the fused run is the host loop's
    ef = {}
    for mode in ('none', 'scan'):
        ef[mode] = run_sim(FLConfig(transport='error_free', wire='packed',
                                    telemetry_flush_every=4,
                                    round_fusion=mode), 5,
                           f'error_free-{mode}', data=data,
                           hook=lambda sim: setattr(sim, 'deterministic',
                                                    True),
                           expect=['quantize_pack', 'spfl_accumulate'])[0]
    same_runs(ef['none'], ef['scan'], 'fused error_free vs the host loop',
              skip=('round_idx',))
    # one population cell fused
    pop_fl = FLConfig(**{**POP_BASE, **dict(POP_RUNS[0][1]),
                         'round_fusion': 'scan',
                         'telemetry_flush_every': 4})
    pop, _, _ = run_sim(pop_fl, 3, 'pop-uniform-scan',
                        expect=kernels_on('round') + ['alloc_solve_f32'])
    ids = [list(map(int, r.cohort_ids)) for r in pop.records]
    if ids != [list(r) for r in POP_UNIFORM_IDS]:
        raise AssertionError('pop-uniform-scan: rounds 0-2 are not the '
                             'pinned cohorts')
    print('pop-uniform-scan: rounds 0-2 are the pinned cohorts of the '
          "reference's key chain", flush=True)
    # a screened, attacked cell: the screen's operations inside the graph
    adv = {}
    for mode in ('none', 'scan'):
        adv[mode] = run_sim(dataclasses.replace(
            fl, attack='signflip', screen=True, round_fusion=mode), 8,
            f'signflip-screen-{mode}', data=data)[1].round_time_s
    print(f'signflip + screen round times: host loop '
          f'{json.dumps([t * 1e3 for t in adv["none"]])} ms, scan '
          f'{json.dumps([t * 1e3 for t in adv["scan"]])} ms', flush=True)
    # every other knob fused, on the card
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        for label, knobs, expect in FUSED_SWEEP:
            modes = ('scan', 'eager') if label == 'retx' else ('scan',)
            for mode in modes:
                path = f'{tmp}/{label}.jsonl' if label == 'dropout' else None
                _, h, _ = run_sim(FLConfig(**{
                    **FUSED_BASE, **knobs, 'telemetry_flush_every': 2,
                    'round_fusion': mode, 'telemetry_path': path}), 3,
                    f'{label}-{mode}', data=data, expect=expect)
                if len(h.payload_bits) != 3 or len(h.loss) != 2:
                    raise AssertionError(f'{label}-{mode}: {len(h.loss)} '
                                         'evaluations, '
                                         f'{len(h.payload_bits)} records')
    print(f'fused sweep: {len(FUSED_SWEEP)} more knobs ran under '
          "'scan' (retx also 'eager') on the card", flush=True)
    # no sync inside a segment: a whole 'scan' segment and 'eager' replays
    for mode, n in (('scan', 4), ('eager', 1)):
        sim = runs[mode][0]
        watch = Watch('sync')
        sim.segment_guard = watch
        sim.run(n)
        torch.cuda.synchronize()
        print(f"fused-{mode}: {len(watch.launches)} segment launch of {n} "
              f"round(s) under set_sync_debug_mode('error'): nothing "
              'waits for the card', flush=True)
    # the device operations of one replayed round, beside the host loop's
    sim = runs['eager'][0]
    watch = Watch('profile')
    sim.segment_guard = watch
    sim.run(1)
    replay = watch.launches[0]
    host = device_launches(lambda: runs['none'][0].run(1))
    print(f"fused-eager: one replayed round (upload, slot copies, graph, "
          f"record copies): {sum(replay['names'].values())} device "
          f"operations {json.dumps(op_kinds(replay['names']))}, busy "
          f"{replay['busy_ms']:.3f} ms of {replay['wall_ms']:.3f} ms, most "
          f"time first {json.dumps(replay['top_ms'])} ms; the host loop's "
          f'round with its evaluation: {sum(host.values())} '
          f'{json.dumps(op_kinds(host))}', flush=True)
    sim = runs['scan'][0]
    watch = Watch('profile')
    sim.segment_guard = watch
    sim.run(4)
    seg = watch.launches[0]
    print(f"fused-scan: one segment of 4 rounds: launch to the card's end "
          f"{seg['wall_ms']:.3f} ms, device busy {seg['busy_ms']:.3f} ms "
          f"(idle share {1 - seg['busy_ms'] / seg['wall_ms']:.4f}; the "
          f"operations' times add to {seg['sum_ms']:.3f} ms), "
          f"{sum(seg['names'].values())} device operations "
          f"{json.dumps(op_kinds(seg['names']))}, most time first "
          f"{json.dumps(seg['top_ms'])} ms", flush=True)
    # the last fused round's float32 solve: timed alone above, held to its
    # plain version on the same card tensors
    last = solves[-1]
    max_iters = fl.allocation_max_iters or 6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = AJ.solve_plain(last['prob'], fl.allocator, max_iters=max_iters,
                           gate=last['gate'])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same_solution(last['sol'], plain, 'alloc_solve_f32 on the last fused '
                  'round')
    print(f'alloc_solve_f32 on the last fused round (K={K}): kernel '
          f'{last["ms"]:.4f} ms, plain {plain_ms:.1f} ms on the card, bit '
          'for bit', flush=True)
    row = {'ms': last['ms'], 'warm_ms': last['ms'], 'plain_ms': plain_ms,
           'max_abs_err': 0.0,
           'bytes': alloc_bytes(1, K, max_iters, real=4),
           'units': alloc_units(last['trips'], K)}
    print(card_line(), flush=True)
    times.update({f'signflip-screen-{m}': t for m, t in adv.items()})
    return {'row': row, 'counts': ran['scan'], 'times': times,
            'alloc': alloc, 'solves': solves}


def kernel_bound(label: str, r: dict, sass_mix, name: str = None):
    """(bound ms, 'bytes' or 'operations') of a launch that moves
    ``r['bytes']`` and does ``r['units']`` units of work of kernel
    ``name`` (default ``label``): the larger of the bytes over the HBM
    rate and the function's operations (``FUNCTION_OPS``) on the busiest
    resource.  Prints both, and the SASS of the build on the same units
    (``sass_mix``, per unit) beside them as a diagnostic."""
    from repro_torch.kernels import sass
    bytes_ms = r['bytes'] / HBM_BYTES_PER_S * 1e3
    ops = launch_mix(FUNCTION_OPS[name or label], r['units'])
    clocks = sass.resource_clocks(ops)
    ops_ms = max(clocks.values()) / (N_SM * SM_CLOCK_HZ) * 1e3
    line = (f'{label}: {r["bytes"]} B -> {bytes_ms:.7f} ms; function '
            f'{json.dumps(ops, sort_keys=True)} operations -> '
            f'{ops_ms:.7f} ms ({max(clocks, key=clocks.get)}-bound)')
    if sass_mix is not None:
        mix = launch_mix(sass_mix, r['units'])
        line += (f'; SASS {json.dumps(mix, sort_keys=True)} '
                 f'thread-instructions, {sum(mix.values())} = '
                 f'{sum(mix.values()) / sum(ops.values()):.2f} x the '
                 'function')
    print(line, flush=True)
    by = 'bytes' if bytes_ms >= ops_ms else 'operations'
    return max(bytes_ms, ops_ms), by


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
    check_spills()

    # 3. kernels against their plain versions
    l_main = 62006
    results = check_kernels(K, l_main, timed=True, seed=1)
    check_kernels(3, 1007, timed=False, seed=2)
    w_mod = results['corrupt_fold'].pop('words')
    for name, units in round_units(K, l_main, w_mod).items():
        results[name]['units'] = units
    print(f'edge sweep: the four round kernels and the six API kernels '
          f'bit-exact at {check_edges(seed=11)} shapes', flush=True)
    check_stale_outputs(seed=12)
    print(f'programmatic dependent launch: {check_grid_waits()} wait before '
          'any global load or store (SASS); read after write, write after '
          'read and two streams agree with the plain versions', flush=True)
    names = check_corrupt_fold_launches()
    print(f'corrupt_fold_words: one kernel, no fill, outputs written whole '
          f'(device operations of one call: {json.dumps(names)})',
          flush=True)
    print('unpack_bits_flat / unpack_dequant_flat: one device operation a '
          f'call, the kernel ({json.dumps(check_unpack_launches())})',
          flush=True)
    results.update(check_api_kernels(2, l_main, BITS, timed=True, seed=5))
    for bits in (1, BITS, 16):
        check_api_kernels(3, 1007, bits, timed=False, seed=6 + bits)
    check_transport(K, l_main, seed=3)
    check_transport(3, 1007, seed=4)
    alloc = check_alloc_kernel(seed=13)
    check_alloc_layouts(seed=14)
    print('kernels and transport agree with their plain versions', flush=True)

    from repro_torch.configs.base import FLConfig
    from repro_torch.wire import format as fmt

    # 4. the main path at full width, with the host solver and then the
    # solver kernel
    fl = FLConfig(wire='packed', channel='bitlevel')
    host_solves = []
    sim, hist, counts = run_sim(
        fl, 5, 'main', hook=lambda s: keep_host_solves(s, host_solves))
    want = fmt.measured_uplink_bits(sim.dim, fl.quant_bits, sim.K)
    if any(b != want for b in hist.payload_bits):
        raise AssertionError(f'payload_bits {hist.payload_bits} != '
                             f'measured frames {want}')
    print(f'main round device operations: {round_launches(sim)}',
          flush=True)
    check_host_problems(host_solves, fl.allocation_max_iters or 2)
    fl_j = FLConfig(wire='packed', channel='bitlevel',
                    allocation_backend='jax')
    device_probs = []
    sim_j, hist_j, counts_j = run_sim(
        fl_j, 5, 'main-jax',
        hook=lambda s: keep_device_problems(s, device_probs))
    if counts_j['alloc_solve'] != 5:
        raise AssertionError(f'main-jax: alloc_solve launched '
                             f'{counts_j["alloc_solve"]} times in 5 rounds')
    if any(b != want for b in hist_j.payload_bits):
        raise AssertionError('main-jax: payload_bits != measured frames')
    for name, h in (('numpy', hist), ('jax', hist_j)):
        print(f'main rounds 1-4, {name} backend: '
              f'{json.dumps([t * 1e3 for t in h.round_time_s[1:]])} ms',
              flush=True)
    solves = time_device_solves(sim_j, device_probs)
    check_no_sync(sim_j)
    round_split(sim_j)
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
    # 7. per-round fading cadence and the paper's baselines
    t0 = time.perf_counter()
    run_fading_and_baselines(sim)
    print(f'phase 7: {time.perf_counter() - t0:.3f} s', flush=True)
    # 8. byzantine clients, stragglers and packed-domain screening
    t0 = time.perf_counter()
    run_adversary(sim, sim_j, hist_j.round_time_s[1:])
    print(f'phase 8: {time.perf_counter() - t0:.3f} s', flush=True)
    # 9. population cohorts and the telemetry ring
    t0 = time.perf_counter()
    run_population(hist_j.round_time_s[1:])
    print(f'phase 9: {time.perf_counter() - t0:.3f} s', flush=True)
    # 10. fused rounds as CUDA graphs, with the float32 in-round solve
    t0 = time.perf_counter()
    fused = run_fused(data_of(sim_j))
    print(f'phase 10: {time.perf_counter() - t0:.3f} s', flush=True)

    leaked = sorted(m for m in sys.modules
                    if m == 'jax' or m.startswith(('jax.', 'repro.'))
                    or m == 'repro')
    if leaked:
        return fail(f'imported {leaked}')

    # the solver kernel's row: the last main-jax round's solve, its plain
    # version once on the same card tensors
    from repro_torch.core import allocation_jax as AJ
    last = solves[-1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = AJ.solve_plain(last['prob'], fl_j.allocator,
                           max_iters=fl_j.allocation_max_iters or 6,
                           gate=last['gate'])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(float((getattr(plain, f).double() - getattr(last['sol'], f)
                     .double()).abs().nan_to_num(0.0).max())
              for f in plain._fields)
    print(f'alloc_solve on the last main-jax round: plain {plain_ms:.1f} ms '
          f'on the card, kernel - plain {err:.3e}', flush=True)
    results['alloc_solve'] = {
        'ms': last['ms'], 'warm_ms': last['ms'], 'plain_ms': plain_ms,
        'max_abs_err': max(err, alloc['max_abs_err']),
        'bytes': alloc_bytes(1, sim_j.K, fl_j.allocation_max_iters or 6),
        'units': alloc_units(last['trips'], sim_j.K)}

    results['alloc_solve_f32'] = fused['row']
    sass_mixes = sass_unit_mixes(build.KERNELS)
    # the float64 solver's launches are main-jax's, the float32 one's the
    # fused main path's ('scan')
    launches = {'round': counts, 'api': api_counts,
                'alloc': {**counts_j, 'alloc_solve_f32':
                          fused['counts']['alloc_solve_f32']}}
    rows = []
    for name, kern in build.TABLE.items():
        r = results[name]
        bound_ms, bound_by = kernel_bound(name, r, sass_mixes.get(name))
        row = {
            'name': name, 'route': 'cuda', 'source': build.repo_source(name),
            'replaces': kern.replaces, 'launches': launches[kern.path][name],
            'path': kern.path, 'max_abs_err': r['max_abs_err'],
            'ms': r['ms'], 'warm_ms': r['warm_ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': None}
        if 'variants' in r:
            row['variants'] = {}
            for label, v in r['variants'].items():
                # the SASS spans are the main call's function and path
                v_bound, v_by = kernel_bound(f'{name} ({label})', v, None,
                                             name)
                row['variants'][label] = {
                    'ms': v['ms'], 'warm_ms': v['warm_ms'],
                    'plain_ms': v['plain_ms'], 'bound_ms': v_bound,
                    'bound_by': v_by}
        rows.append(row)
    print(card, flush=True)
    print(json.dumps({'kernels': rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
