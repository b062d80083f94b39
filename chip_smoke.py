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
   the profiler's count of the 'scan' run);
11. the LLM-scale FL step (``run_llm``): ``launch.train.run(
   'smollm-135m', steps=4, clients=4, batch=8, seq=256, wire='packed',
   allocator='barrier', allocation_backend='jax')`` at full width
   (134,515,008 bf16 parameters in 11 leaves) with the counters reset
   just before and read just after (11 ``quantize_pack`` and 11
   ``spfl_accumulate`` a step, one ``alloc_solve`` a step from step 1,
   nothing else), each step's time and loss, each solve again alone with
   its trips; two steps under ``torch.profiler`` (the kernels the card
   ran per step; step 1 split into gradients, stats, solve, transport
   and update, with the device's idle share); one bit-level
   ``make_fl_train_step`` step (22 ``corrupt_fold``) and one error_free
   step, each with exact launch counts; the three kernels of the tree
   step against their plain versions on the bit-level step's gradients
   at the embedding (n = 28,311,552) and final_norm (n = 576) leaves,
   ``corrupt_fold`` at the step's BER and at BER 0 and 1, timed at the
   embedding leaf (``llm_leaf_kernels``); and the reduced model's tree
   transport on the card against the CPU given the same gradients and
   draws (``check_llm_transport_card_vs_cpu``).

12. the sharded collective, fused LLM rounds and LLM population mode
    (``run_sharded``, ``run_llm_fused``): the flat transports (spfl,
    spfl_retx, error_free; packed, bit-level) at K=20, l=62,006, the tree
    transports over the CNN's parameter tree, K=5 (ragged) and the sum
    and votes of K=40 clients, sharded at S = 1 over NCCL in this process
    and at S = 2 and 4 gloo ranks (``--shard-rank``: processes of this
    script on the one card), each against the gathered call: integers
    bit for bit, f32 within S x the FMA-wobble bound (bit for bit at S =
    1), every rank's ĝ the same bits; at S = 2 two sharded smollm-135m
    steps against the gathered transport on the same gradients; then
    six fused smollm-135m rounds (segments of 4 and 2, barrier) twice
    under 'eager' and twice under 'scan' ('scan' = 'eager' bit for bit,
    losses, (q, p) and telemetry rows; each round's ``alloc_solve_f32`` =
    its plain version bit for bit; the first run's warm-up and segments
    under sync debug mode 'error'; one segment's kernels and idle share
    under ``torch.profiler``), fused error_free against the host loop
    bit for bit, and one population 'scan' segment (N = 10^6, cohort 4)
    whose cohort ids are the host chain's.

13. the rest of the model zoo, prefill/decode and serving (``run_zoo``):
    ``launch.train.run`` on the packed wire and the bit channel, barrier,
    'jax', with the counters reset just before and read just after (one
    ``quantize_pack`` and one ``spfl_accumulate`` a leaf a step, two
    ``corrupt_fold`` a leaf a step, one ``alloc_solve`` a step from step
    1, nothing else, a leaf counted from the configuration): mamba2-130m
    at full width and depth (K = 4 clients of 8 x 256 tokens, 2 steps),
    at full width cut to one group of their layer pattern (K = 2 of 2 x
    128) mixtral-8x7b (1 layer, 1 step), zamba2-2.7b (6 layers, the
    shared block once), paligemma-3b and musicgen-medium (1 layer; 2
    steps each), and the reduced arctic-480b (2 steps; one full-width
    layer is 13.4 G parameters); the reduced arctic's standard step,
    paligemma-3b's (1 layer, full width) step given a bf16 prefix batch
    of 256 x 1152; one fused segment of 2 rounds on mamba2-130m and
    on the reduced mixtral under 'scan' and 'eager', bit for bit, each
    warm-up and segment under sync debug mode 'error'; serving at full
    width through ``launch.serve.run`` (batch 4, prompt 128, greedy):
    smollm-135m and mamba2-130m (32 new tokens), mixtral-8x7b one layer
    (16, with each MoE call's ``drop_frac``), each with its prefill ms,
    decode ms a token, tokens a second, one decode step under
    ``torch.profiler`` (device operations, busy ms, idle share) and its
    output fed back through the full-sequence forward (``check_served``);
    a float32 copy of smollm-135m and mamba2-130m served for 8 tokens,
    its decode within 1e-4 of each row's largest |logit| of its float32
    forward (``check_served_f32``); and decode = forward within 3e-3 on
    every reduced architecture (gemma2 and mixtral past their window).

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
(bits 1, mod_ok 0); those of quantize_pack, spfl_accumulate (no votes)
and corrupt_fold add ``llm``, the same at phase 11's embedding leaf
(K=4), with the launches of phase 11's run (``corrupt_fold``: its
bit-level step); ``phase12_launches`` counts phase 12's launches on
every rank (a graph's at its capture), ``phase13_launches`` phase 13's.  It imports
nothing of JAX and nothing of the reference package ``repro``.  Kernel libraries are built under
``build/torch_kernels/``.
"""
from __future__ import annotations

import itertools
import json
import math
import os
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
# spfl_accumulate's function with no vote output (the tree transports,
# phase 11): the client's sign bit, knob planes, selects and sums as
# above, no vote bit, no popcount
NO_VOTE_OPS = {'client': {'alu': 3 + BITS, 'shift': 1 + BITS,
                          'bitset': BITS, 'fp32': 5, 'xu': 1}}
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


PROFILE_PAD_S = 0.02


def card_profile(cpu: bool = False):
    """``torch.profiler`` of the card's operations (and the host's when
    ``cpu``) over the body of a ``with``, its window held open
    ``PROFILE_PAD_S`` with the card idle before the body and again after
    the card has finished it.  A window that opens just before a launch
    and closes just after the card's last operation now and then comes
    back with no device record at all, in bursts that can take several
    windows in a row; one padded so has not, in a probe of the same call
    over a minute and more."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)

    @contextlib.contextmanager
    def window():
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            time.sleep(PROFILE_PAD_S)
            yield prof
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
    return window()


def device_launches(fn, tries: int = 3) -> dict:
    """{name: count} of the device operations (kernels, memsets, copies)
    that ``fn()`` runs, from ``torch.profiler``'s CUDA records over a
    padded window (``card_profile``).  A profile that holds no device
    record at all is taken again, up to ``tries`` times."""
    import collections
    import torch
    names = {}
    for _ in range(tries):
        with card_profile() as prof:
            fn()
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
    """Each kept round's solve again, alone (``timed_solve``).  -> one
    dict per round."""
    import torch
    from repro_torch.kernels import ops
    fl = sim.fl
    layout = ops.alloc_layout(1, sim.K, fl.allocator)
    print(f'{label} solve layout (K={sim.K}): {json.dumps(layout)}',
          flush=True)
    out = []
    for n, stats in enumerate(kept):
        prob, gate = stats['prob'], torch.amax(stats['gb2'])
        r = timed_solve(prob, fl.allocator, fl.allocation_max_iters or 6,
                        fl.allocation_tol or 1e-5, fl.allocation_early_exit,
                        gate)
        out.append(dict(round=n, ms=r['ms'], iters=r['iters'],
                        exit_reason=r['exit_reason'],
                        trips=list(r['trips'].values()), prob=prob,
                        gate=gate, sol=r['sol'], spine=r['spine']))
        print(f'{label} round {n}: alloc_solve kernel {r["ms"]:.4f} ms, '
              f'iters_used {r["iters"]}, exit_reason {r["exit_reason"]}, '
              f'spine only {r["spine"]}, trips {json.dumps(r["trips"])}',
              flush=True)
    return out


def timed_solve(prob, method: str, max_iters: int, tol: float,
                early_exit: bool, gate=None) -> dict:
    """One solve again, alone: its kernel ms (CUDA events, median of 5),
    trip counts (``ops.ALLOC_TRIPS`` names), effort and whether its dual
    searches kept to the spine."""
    import torch
    from repro_torch.kernels import ops
    nodes = ops.alloc_layout(1, prob.A.shape[-1], method)['nodes']
    trips = torch.zeros((1, len(ops.ALLOC_TRIPS)), dtype=torch.int32,
                        device='cuda')

    def solve():
        return ops.alloc_solve(prob, method, max_iters=max_iters, tol=tol,
                               early_exit=early_exit, gate=gate, trips=trips)

    ms = device_ms([solve], reps=5, inner=1)
    sol = solve()
    torch.cuda.synchronize()
    named = dict(zip(ops.ALLOC_TRIPS, trips[0].tolist()))
    return dict(ms=ms, iters=int(sol.iters), exit_reason=int(sol.exit_reason),
                trips=named, spine=spine_only(named, nodes), sol=sol)


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
    cpu = torch.autograd.DeviceType.CPU
    for _ in range(tries):
        with card_profile(cpu=True) as prof:
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
    cpu = torch.autograd.DeviceType.CPU
    out = {}
    for label, sim in (('screened', screened), ('plain', plain)):
        for _ in range(tries):
            with card_profile(cpu=True) as prof:
                sim.run(1)
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
            with card_profile() as prof:
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


# ---------------------------------------------------------------------------
# phase 11: the LLM-scale FL step on smollm-135m at full width
# ---------------------------------------------------------------------------

LLM_ARCH = 'smollm-135m'
LLM_K = 4
# launch.train.run's sizes and the launcher's own defaults (its main())
LLM_RUN = dict(clients=LLM_K, batch=8, seq=256, transport_kind='spfl',
               allocator='barrier', lr=0.05, bandwidth_hz=10e9,
               tx_power_dbm=-4.0, wire='packed', allocation_backend='jax')
LLM_STEPS = 4
STEP_SPANS = ('step/gradients', 'step/stats', 'step/solve',
              'step/transport', 'step/update')
# the three kernels of the tree step, held at its largest and smallest
# leaves (the tree order's 'embed' and 'final_norm')
LLM_KERNELS = ('quantize_pack', 'spfl_accumulate', 'corrupt_fold')
LLM_LEAVES = (('embed', 0), ('final_norm', 1))


def keep_llm_solves(kept: list):
    """Keep each solve of ``launch.train``'s 'jax' backend (its problem
    and options) by wrapping ``allocation_jax.solve_from_stats``, the
    function the launcher calls.  -> a callable that undoes the wrap."""
    from repro_torch.core import allocation_jax as AJ
    orig = AJ.solve_from_stats

    def wrapped(g2, gb2, v, d2, gains, p_w, dim, fl, method='alternating',
                max_iters=6, tol=1e-5, early_exit=True, device=None):
        prob = AJ.problem_from_stats(g2, gb2, v, d2, gains, p_w, dim, fl,
                                     device=device)
        sol = AJ.solve_traceable(prob, method, max_iters, tol,
                                 early_exit=early_exit)
        kept.append(dict(prob=prob, method=method, max_iters=max_iters,
                         tol=tol, early_exit=early_exit))
        return sol

    AJ.solve_from_stats = wrapped
    return lambda: setattr(AJ, 'solve_from_stats', orig)


def llm_step_split(prof) -> dict:
    """The last step of a profiled ``launch.train`` run from its
    ``torch.profiler`` record: the host and device ms of each span of
    ``STEP_SPANS`` (the device side: the profiler's span of the
    annotation, from its first to the end of its last device operation),
    the step's wall ms (its host span, which ends in a host read of the
    step's results), the device's busy ms (the union of its operations'
    intervals in the step) and idle share."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    host, device, steps, ops_ = {}, {}, [], []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        rng = (e.time_range.start, e.time_range.end)
        if e.name == 'step' and e.device_type == cpu:
            steps.append(rng)
        elif e.name in STEP_SPANS:
            (host if e.device_type == cpu else device)[e.name] = rng
        elif e.device_type != cpu and not e.name.startswith('step'):
            ops_.append(rng)          # an operation, not an annotation
    a, b = steps[-1]
    busy = busy_ms([(s, min(t, b)) for s, t in ops_ if a <= s < b])
    wall = (b - a) / 1e3

    def ms(r):
        return (r[1] - r[0]) / 1e3 if r else 0.0

    return dict(wall_ms=wall, busy_ms=busy, idle=1 - busy / wall,
                host={n: ms(host.get(n)) for n in STEP_SPANS},
                device={n: ms(device.get(n)) for n in STEP_SPANS})


def llm_profile() -> dict:
    """Two steps of phase 11's run under ``torch.profiler``: the kernels
    the card ran, per step (step 0 solves nothing, step 1 once), and the
    split of step 1 (``llm_step_split``)."""
    import torch
    from repro_torch.launch import train
    with card_profile(cpu=True) as prof:
        train.run(LLM_ARCH, steps=2, **LLM_RUN)
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    kinds = op_kinds(names)
    per_step = {'quantize_pack': kinds.get('quantize_pack', 0) / 2,
                'spfl_accumulate': kinds.get('spfl_accumulate', 0) / 2,
                'alloc_solve': kinds.get('alloc_solve', 0),
                'corrupt_fold': kinds.get('corrupt_fold', 0) / 2}
    print(f'llm launches per step (torch.profiler, 2 steps, the solve in '
          f'step 1): {json.dumps(per_step)}; device operations '
          f'{sum(names.values())}', flush=True)
    want = {'quantize_pack': 11, 'spfl_accumulate': 11, 'alloc_solve': 1,
            'corrupt_fold': 0}
    if per_step != want:
        raise AssertionError(f'llm: the card ran {per_step}, want {want}')
    split = llm_step_split(prof)
    print(f'llm step 1 split (torch.profiler): wall {split["wall_ms"]:.3f} '
          f'ms, device busy {split["busy_ms"]:.3f} ms (idle share '
          f'{split["idle"]:.4f})', flush=True)
    for name in STEP_SPANS:
        print(f'  {name}: host {split["host"][name]:.3f} ms, device '
              f'{split["device"][name]:.3f} ms', flush=True)
    return dict(per_step=per_step, split=split)


def llm_params(cfg, seed: int):
    """Random full-width weights on the card (the launcher's own
    initializer and generator)."""
    import torch
    from repro_torch import tree
    from repro_torch.models import transformer as tf
    return tree.map(lambda t: t.to('cuda'),
                    tf.init_params(cfg, torch.Generator().manual_seed(seed)))


def llm_step(label: str, fl, kind: str, want: dict, seed: int,
             q=None, p=None) -> dict:
    """One ``make_fl_train_step`` step of smollm-135m at full width (K=4
    clients of 8 x 256 tokens) with the launch counters reset just before
    and read just after: exactly ``want`` launches, finite outputs.  The
    step's gradients and stats are kept (``client_grads`` wrapped)."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import transport as tr
    from repro_torch.data import synth_tokens
    from repro_torch.kernels import ops
    from repro_torch.training import distributed as dist
    cfg = get_arch(LLM_ARCH)
    params = llm_params(cfg, seed)
    toks = synth_tokens(LLM_K * 8, 256, cfg.vocab_size, seed)
    toks = torch.as_tensor(toks.reshape(LLM_K, 8, 256), device='cuda')
    gbar = dist.init_gbar(params)
    ones = torch.ones((LLM_K,), device='cuda')
    q = ones if q is None else q
    p = ones if p is None else p
    gen = torch.Generator(device='cuda').manual_seed(seed)
    host = torch.Generator().manual_seed(seed)
    sizes = [int(x.numel()) for x in tree.leaves(params)]
    draws = tr.make_tree_draws(LLM_K, sizes, 0, fl.channel, 'cuda', gen,
                               host, kind=kind)
    kept = []
    orig = dist.client_grads

    def keep(*args, **kw):
        kept.append(orig(*args, **kw))
        return kept[-1]

    step = dist.make_fl_train_step(cfg, fl, kind)
    dist.client_grads = keep
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        new_params, new_gbar, m = step(params, {'tokens': toks}, gbar, q, p,
                                       draws)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(ops.launch_counts)
    finally:
        dist.client_grads = orig
    got = {name: counts[name] for name in want}
    others = {n: c for n, c in counts.items() if n not in want and c}
    if got != want or others:
        raise AssertionError(f'{label}: launches {counts}, want {want}')
    if not all(bool(torch.isfinite(x).all()) for x in
               tree.leaves(new_params) + tree.leaves(new_gbar)):
        raise AssertionError(f'{label}: non-finite parameters or gbar')
    tel = m['telemetry']
    print(f'{label}: {ms:.3f} ms (a first step, warm-up included), loss '
          f'{float(m["loss"]):.6f}, sign_ok {tel.sign_ok.tolist()}, mod_ok '
          f'{tel.mod_ok.tolist()}, payload_bits '
          f'{float(m["payload_bits"]):.0f}, launches {json.dumps(got)}',
          flush=True)
    losses, grads = kept[0]
    return dict(ms=ms, counts=counts, grads=grads, params=params, q=q, p=p,
                telemetry=tel, stats=tr.tree_client_stats(grads))


def llm_leaf_kernels(bit: dict, timed_leaf: str = 'embed') -> dict:
    """The three kernels of the tree step against their plain versions on
    the bit-level step's own gradients at the embedding and final_norm
    leaves (K=4, the tree-wide ranges): quantize_pack's words, then
    corrupt_fold on the knob words at the step's modulus BER and at BER
    0 and 1 (received words, folds, flip counts), then spfl_accumulate
    without votes on the step-BER words with a shared ḡ, all bit for bit
    but the f32 sum, held to the FMA-wobble bound.  At ``timed_leaf``
    each kernel is timed from device memory (``kernel_ms``) and its plain
    version (median of 3), with its bytes and units of work for the
    bound.  -> {kernel: row extras}."""
    import torch
    from repro_torch import tree
    from repro_torch.core import bitchannel
    from repro_torch.core.quantize import knob_step
    from repro_torch.kernels import build, ops, ref
    from repro_torch.wire import corrupt as wire_corrupt
    from repro_torch.wire import format as fmt
    k = LLM_K
    leaves = tree.leaves(bit['grads'])
    stats = bit['stats']
    gmin, gmax = stats['g_min'].contiguous(), stats['g_max'].contiguous()
    # the step's modulus BER: every leaf's knob words plus the framing
    wm = sum(fmt.n_groups(int(x[0].numel())) * BITS for x in leaves) + (
        fmt.MOD_HEADER_WORDS + fmt.CRC_WORDS)
    ber_step = bitchannel.ber_for_success(bit['p'], wm)
    gen = torch.Generator(device='cuda').manual_seed(31)
    out = {}
    for leaf, i in LLM_LEAVES:
        g = leaves[i].to(torch.float32).reshape(k, -1).contiguous()
        n = g.shape[1]
        groups = fmt.n_groups(n)
        rand = torch.rand((k, n), generator=gen, device='cuda')
        sw, qw = ops.quantize_pack_flat(g, rand, gmin, gmax, BITS)
        rsw, rqw = ref.quantize_pack(g, rand, gmin, gmax, BITS)
        if max(int_err(sw, rsw), int_err(qw, rqw)):
            raise AssertionError(f'llm {leaf}: quantize_pack differs')
        del rsw, rqw
        timed = leaf == timed_leaf
        if timed:
            out['quantize_pack'] = dict(
                leaf=leaf, n=n, k=k, max_abs_err=0.0,
                bytes=k * n * 8 + k * 8 + k * groups * (1 + BITS) * 4,
                units=quantize_pack_units(k, n, BITS))
            out['quantize_pack'].update(kernel_ms(
                build.kernel('quantize_pack'), (g, rand, gmin, gmax, sw, qw),
                lambda *t: (*(x.data_ptr() for x in t), k, n, BITS,
                            torch.cuda.current_stream().cuda_stream)))
            out['quantize_pack']['plain_ms'] = device_ms(
                [lambda: ref.quantize_pack(g, rand, gmin, gmax, BITS)],
                reps=3, inner=1)
        del g, rand
        # the bit channel on the knob words
        seeds = ops.seed_words((0x5EED0000 + i, 0x0BADCAFE), 'cuda')
        rx_step = None
        for label, ber in (('step', ber_step),
                           ('0', torch.zeros((k,), device='cuda')),
                           ('1', torch.ones((k,), device='cuda'))):
            rx, fold, flips = ops.corrupt_fold_words(seeds, qw, ber)
            th, allf = wire_corrupt.flip_threshold(ber)
            th = fmt.to_words(th).contiguous()
            allf = allf.to(torch.int32).contiguous()
            rrx, rfold, rflips = ref.corrupt_fold(seeds, qw, th, allf)
            if (int_err(rx, rrx) or int_err(fold, rfold)
                    or not torch.equal(flips, rflips)):
                raise AssertionError(f'llm {leaf}: corrupt_fold differs at '
                                     f'BER {label}')
            total = [int(x) for x in flips.tolist()]
            print(f'llm {leaf} corrupt_fold at BER {label}: flips {total} '
                  f'(bit for bit)', flush=True)
            if label == '1' and total != [qw.shape[1] * 32] * k:
                raise AssertionError(f'llm {leaf}: BER 1 flipped {total}')
            if label == '0' and any(total):
                raise AssertionError(f'llm {leaf}: BER 0 flipped {total}')
            if label == 'step':
                rx_step = rx
                if timed:
                    w = qw.shape[1]
                    stream = torch.cuda.current_stream().cuda_stream
                    out['corrupt_fold'] = dict(
                        leaf=leaf, n=n, k=k, words=w, max_abs_err=0.0,
                        ber=ber.tolist(), bytes=2 * k * w * 4 + k * 16,
                        units=corrupt_fold_units(k, w))
                    out['corrupt_fold'].update(kernel_ms(
                        build.kernel('corrupt_fold'),
                        (qw, rx, th, allf, fold, flips),
                        corrupt_fold_args(k, w, seeds, stream)))
                    out['corrupt_fold']['plain_ms'] = device_ms(
                        [lambda: ref.corrupt_fold(seeds, qw, th, allf)],
                        reps=3, inner=1)
            del rrx
        # the PS decode of the received words, shared ḡ, no votes
        gbar = torch.rand((n,), generator=gen, device='cuda') * float(
            gmax.max()) * 0.5
        mod_ok = torch.tensor([True, True, False, True], device='cuda')
        sign_ok = torch.ones((k,), dtype=torch.bool, device='cuda')
        weight = sign_ok.to(torch.float32) / bit['q']
        acc, votes = ops.spfl_aggregate_packed(sw, rx_step, gbar, gmin, gmax,
                                               mod_ok, weight, sign_ok, n,
                                               BITS, with_votes=False)
        step = knob_step(gmin, gmax, BITS)
        mok = mod_ok.to(torch.float32)
        gate = sign_ok.to(torch.int32)
        racc, _ = ref.spfl_accumulate(sw, rx_step, gbar, gmin, step, mok,
                                      weight, gate, n, BITS, False)
        err = float((acc - racc).abs().max())
        tol = ulp_atol(weight, gmax, gbar)
        if votes is not None or not same_f32(acc, racc) or err > tol:
            raise AssertionError(f'llm {leaf}: spfl_accumulate differs '
                                 f'({err} > {tol})')
        print(f'llm {leaf} (n={n}): quantize_pack, corrupt_fold bit for '
              f'bit; spfl_accumulate (no votes) within {err:.3e} of its '
              f'plain version (bound {tol:.3e})', flush=True)
        if timed:
            stream = torch.cuda.current_stream().cuda_stream
            tensors = (sw, rx_step, gbar, gmin, step, mok.contiguous(),
                       weight.contiguous(), gate, acc)
            out['spfl_accumulate'] = dict(
                leaf=leaf, n=n, k=k, max_abs_err=err,
                bytes=k * groups * (1 + BITS) * 4 + n * 8 + k * 20,
                units=spfl_accumulate_units(k, n, BITS))
            out['spfl_accumulate'].update(kernel_ms(
                build.kernel('spfl_accumulate'), tensors,
                lambda sp, mp, *t: (sp.data_ptr(), sp.stride(0),
                                    mp.data_ptr(), mp.stride(0),
                                    t[0].data_ptr(), 0,
                                    *(x.data_ptr() for x in t[1:]), None, k,
                                    n, BITS, stream)))
            out['spfl_accumulate']['plain_ms'] = device_ms(
                [lambda: ref.spfl_accumulate(sw, rx_step, gbar, gmin, step,
                                             mok, weight, gate, n, BITS,
                                             False)], reps=3, inner=1)
        del sw, qw, rx_step, acc, racc, gbar
        torch.cuda.empty_cache()
    return out


def check_llm_transport_card_vs_cpu(seed: int = 41) -> None:
    """At reduced width (``smollm-135m-reduced``, float32, K=4) the tree
    transport on the card given the CPU's gradients and draws: SP-FL on
    the packed bit channel with one sign resend, and error_free packed.
    Every integer bit for bit, ĝ within the FMA-wobble bound."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import transport as tr
    from repro_torch.data import synth_tokens
    from repro_torch.models import transformer as tf
    from repro_torch.training import distributed as dist
    cfg = get_arch(LLM_ARCH + '-reduced')
    gen = torch.Generator().manual_seed(seed)
    params = tf.init_params(cfg, gen)
    toks = torch.as_tensor(synth_tokens(LLM_K * 2, 65, cfg.vocab_size, seed)
                           .reshape(LLM_K, 2, 65))
    _, grads = dist.client_grads(params, cfg, toks)
    gbar = tree.map(lambda x: torch.rand(x.shape, generator=gen) * 1e-3,
                    params)
    q = torch.linspace(0.4, 1.0, LLM_K)
    p = torch.linspace(1.0, 0.4, LLM_K)
    sizes = [int(x.numel()) for x in tree.leaves(params)]
    for kind, fl, n_retx in (
            ('spfl', FLConfig(n_devices=LLM_K, wire='packed',
                              channel='bitlevel'), 1),
            ('error_free', FLConfig(n_devices=LLM_K, wire='packed'), 0)):
        draws = tr.make_tree_draws(LLM_K, sizes, n_retx, fl.channel, 'cpu',
                                   gen, gen, kind=kind)
        draws = draws._replace(rand=[draws.rand[i] for i in range(len(sizes))])
        out = {}
        for dev in ('cuda', 'cpu'):
            d = draws._replace(rand=[r.to(dev) for r in draws.rand],
                               **{f: getattr(draws, f).to(dev)
                                  for f in ('seeds', 'sign_u', 'mod_u')
                                  if getattr(draws, f) is not None})
            g_d = tree.map(lambda x: x.to(dev), grads)
            if kind == 'spfl':
                ghat, stats, tel = tr.spfl_aggregate_tree(
                    g_d, tree.map(lambda x: x.to(dev), gbar), q.to(dev),
                    p.to(dev), fl, d, n_retx=n_retx)
            else:
                ghat, stats, tel = tr.error_free_aggregate_tree(g_d, fl, d)
            out[dev] = ([x.cpu() for x in tree.leaves(ghat)], tel.to_host(),
                        stats['g_max'].cpu())
        (g_gpu, t_gpu, gmax), (g_cpu, t_cpu, _) = out['cuda'], out['cpu']
        for name, val in t_cpu._asdict().items():
            other = getattr(t_gpu, name)
            if (val is None) != (other is None) or (
                    val is not None and not (val == other).all()):
                raise AssertionError(f'llm reduced {kind} {name}: card != '
                                     'CPU')
        gb_max = max(float(x.max()) for x in tree.leaves(gbar))
        weight = torch.as_tensor(t_cpu.sign_ok, dtype=torch.float32) / (
            q if kind == 'spfl' else 1.0)
        tol = ulp_atol(weight, gmax, torch.tensor([gb_max])) / LLM_K
        err = max(float((a - b).abs().max()) for a, b in zip(g_gpu, g_cpu))
        if err > tol:
            raise AssertionError(f'llm reduced {kind}: ghat card - CPU {err} '
                                 f'> {tol}')
        flips = (0 if t_cpu.sign_flips is None
                 else int(t_cpu.sign_flips.sum() + t_cpu.mod_flips.sum()))
        if kind == 'spfl' and flips == 0:
            raise AssertionError('llm reduced: the bit channel drew no flips')
        print(f'llm reduced {kind}: card = CPU (integers bit for bit, ghat '
              f'within {err:.3e} <= {tol:.3e}; flips {flips})', flush=True)


def run_llm() -> dict:
    """Phase 11: ``launch.train.run('smollm-135m', ...)`` at full width
    for ``LLM_STEPS`` steps (the launcher's sizes: K=4 clients of 8 x 256
    tokens, packed wire, barrier allocator, 'jax' backend) with the
    counters reset just before and read just after (11 ``quantize_pack``
    and 11 ``spfl_accumulate`` a step, one ``alloc_solve`` a step from
    step 1, nothing else), each solve again alone with its trips; two
    steps under ``torch.profiler`` (the launches per step, the split of
    step 1, the idle share); one bit-level step (22 ``corrupt_fold``),
    one error_free step; the three kernels at the embedding and
    final_norm leaves (``llm_leaf_kernels``); the reduced model's
    transport on the card against the CPU.  -> {'rows': the three
    kernels' timed leaf results, 'launches': the counts of the run}."""
    import torch
    from repro_torch.configs.base import FLConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    kept = []
    undo = keep_llm_solves(kept)
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        hist = train.run(LLM_ARCH, steps=LLM_STEPS, **LLM_RUN)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = dict(ops.launch_counts)
    finally:
        undo()
    print(f'llm run ({LLM_ARCH}, {LLM_STEPS} steps, set-up included): '
          f'{run_s:.3f} s; step ms '
          f'{json.dumps([t * 1e3 for t in hist["step_s"]])}; loss '
          f'{json.dumps(hist["loss"])}; q̄ {json.dumps(hist["q"])}; p̄ '
          f'{json.dumps(hist["p"])}', flush=True)
    print(f'llm launches: {json.dumps(counts)}', flush=True)
    if not all(math.isfinite(x) for x in hist['loss']):
        raise AssertionError(f'llm: non-finite loss {hist["loss"]}')
    want = {'quantize_pack': 11 * LLM_STEPS, 'spfl_accumulate': 11 * LLM_STEPS,
            'alloc_solve': LLM_STEPS - 1}
    if ({n: counts[n] for n in want} != want
            or any(c for n, c in counts.items() if n not in want)):
        raise AssertionError(f'llm: launches {counts}, want {want}')
    if len(kept) != LLM_STEPS - 1:
        raise AssertionError(f'llm: {len(kept)} solves kept')
    solves = []
    for n, s in enumerate(kept, start=1):
        r = timed_solve(s['prob'], s['method'], s['max_iters'], s['tol'],
                        s['early_exit'])
        solves.append({key: r[key] for key in ('ms', 'iters', 'exit_reason',
                                               'spine')})
        print(f'llm step {n}: alloc_solve kernel {r["ms"]:.4f} ms, '
              f'iters_used {r["iters"]}, exit_reason {r["exit_reason"]}, '
              f'spine only {r["spine"]}, trips {json.dumps(r["trips"])}',
              flush=True)
    profiled = llm_profile()
    fl_bit = FLConfig(n_devices=LLM_K, learning_rate=LLM_RUN['lr'],
                      bandwidth_hz=LLM_RUN['bandwidth_hz'], wire='packed',
                      channel='bitlevel')
    q = torch.tensor([0.55, 0.7, 0.85, 1.0], device='cuda')
    p = torch.tensor([0.9, 0.6, 0.75, 0.95], device='cuda')
    bit = llm_step('llm bitlevel step', fl_bit, 'spfl',
                   {'quantize_pack': 11, 'spfl_accumulate': 11,
                    'corrupt_fold': 22}, seed=3, q=q, p=p)
    tel = bit['telemetry']
    if int(tel.sign_flips.sum() + tel.mod_flips.sum()) == 0:
        raise AssertionError('llm bitlevel step: the channel drew no flips')
    print(f'llm bitlevel step: flips sign {tel.sign_flips.tolist()} mod '
          f'{tel.mod_flips.tolist()}', flush=True)
    rows = llm_leaf_kernels(bit)
    del bit
    torch.cuda.empty_cache()
    llm_step('llm error_free step',
             FLConfig(n_devices=LLM_K, wire='packed'), 'error_free',
             {'quantize_pack': 11, 'spfl_accumulate': 11}, seed=4)
    torch.cuda.empty_cache()
    check_llm_transport_card_vs_cpu()
    launches = {'quantize_pack': counts['quantize_pack'],
                'spfl_accumulate': counts['spfl_accumulate'],
                'corrupt_fold': 22}
    return dict(rows=rows, launches=launches, step_ms=[
        t * 1e3 for t in hist['step_s']], solves=solves, **profiled)


# ---------------------------------------------------------------------------
# phase 12: the sharded collective, fused LLM rounds, LLM population mode
# ---------------------------------------------------------------------------

SHARD_WORLDS = (2, 4)       # gloo ranks as processes on the one card
SHARD_TIMEOUT_S = 300
# fused LLM rounds: six rounds in segments of 4 and 2 (the launcher's
# sizes; barrier, 'jax')
LLM_FUSED = dict(LLM_RUN, steps=6, scan_segment_rounds=4)
LLM_POP = dict(population_n=10 ** 6, cohort_size=LLM_K)
# ||g_k||^2 is a float32 row sum whose CUDA reduction splits by the
# tensor's shape: a rank's K_local rows may round otherwise than K rows
# (at S = 1 the shapes are the same and the sums equal bit for bit)
G2_RTOL = 1e-5
# the sharded smollm step against the 4-client pass's: the same clients'
# bf16 gradient pass batched over 4 clients instead of 2, whose GEMMs
# accumulate in another order, so a bf16 value may round to a neighbour:
# losses, ||g_k||^2 and max |g_k| within four bf16 ulps, relative (one
# ulp is 2^-8 to 2^-7 of the value); a pass that goes wrong by more than
# bf16 rounding fails
VMAP_RTOL = 4 * 2.0 ** -8
# the kernels of the phase's paths, each of which must launch
PHASE12_KERNELS = ('quantize_pack', 'spfl_accumulate', 'corrupt_fold',
                   'fold_words', 'alloc_solve_f32')


def ulp_bound(weight, gmax, gbar_max: float) -> float:
    """The FMA-wobble bound of a client sum (``tests/test_torch_parity.
    ulp_atol``): 4 eps x sum_k w_k max(gmax_k, max |ḡ|)."""
    import torch
    w = torch.as_tensor(weight, dtype=torch.float64).abs().cpu()
    g = torch.as_tensor(gmax, dtype=torch.float64).cpu()
    scale = float(torch.sum(w * torch.clamp(g, min=gbar_max)))
    return 4 * 2.0 ** -23 * max(scale, 1.0)


class ShardCheck:
    """One rank's comparisons of sharded calls with the gathered ones:
    integers bit for bit, f32 within S x the bound (bit for bit at S =
    1), and every rank's result the same bits."""

    def __init__(self, mesh):
        self.mesh, self.S = mesh, mesh.size
        self.cases = {}

    def same_bits(self, label, t):
        import torch
        mine = t.detach().reshape(1, -1).contiguous().view(torch.int32)
        every = self.mesh.all_gather(mine)
        if not all(torch.equal(every[r], mine[0])
                   for r in range(self.S)):
            raise AssertionError(f'{label}: ranks hold different bits')

    def f32(self, label, got, want, atol):
        err = float((got.double() - want.double()).abs().max())
        bound = 0.0 if self.S == 1 else self.S * atol
        if err > bound:
            raise AssertionError(f'{label}: f32 {err} > bound {bound}')
        case = self.cases.setdefault(label, {'max_err': 0.0, 'bound': 0.0})
        case['max_err'] = max(case['max_err'], err)
        case['bound'] = max(case['bound'], bound)

    def rel(self, label, got, want, rtol, exact_at_one=True):
        """A float32 reduction whose order follows the shape it runs on
        (a row sum over K_local rows or over K): within ``rtol``, and bit
        for bit at S = 1 (the same shapes) unless ``exact_at_one`` is
        False."""
        err = float(((got.double() - want.double()).abs()
                     / want.double().abs().clamp(min=1e-30)).max())
        bound = 0.0 if self.S == 1 and exact_at_one else rtol
        if err > bound:
            raise AssertionError(f'{label}: relative {err} > {bound}')
        case = self.cases.setdefault(label, {'max_err': 0.0,
                                             'bound': bound})
        case['max_err'] = max(case['max_err'], err)

    def ints(self, label, got, want):
        import torch
        if (got is None) != (want is None) or (
                want is not None and not torch.equal(got, want)):
            raise AssertionError(f'{label}: integers differ')

    def telemetry(self, label, got, want):
        for f in ('sign_ok', 'mod_ok', 'sign_flips', 'mod_flips',
                  'sign_crc_ok', 'retx_attempts', 'sign_votes',
                  'payload_bits', 'retransmissions'):
            self.ints(f'{label}.{f}', getattr(got, f), getattr(want, f))


def shard_flat(chk, kind: str, k: int, l: int, seed: int) -> dict:
    """One flat packed bit-level transport (spfl, spfl_retx or
    error_free) of K clients of l coordinates, gathered and sharded on
    the same global draws."""
    import torch
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import transport as tr
    mesh, dev = chk.mesh, torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = torch.randn((k, l), generator=gen, device=dev) * 0.05
    gbar = torch.rand((l,), generator=gen, device=dev) * 0.05
    q = 0.55 + 0.44 * torch.rand((k,), generator=gen, device=dev)
    p = 0.55 + 0.44 * torch.rand((k,), generator=gen, device=dev)
    n_retx = 1 if kind == 'spfl_retx' else 0
    draws = tr.make_draws(k, l, n_retx, 'bitlevel', dev, gen,
                          torch.Generator().manual_seed(seed),
                          kind='error_free' if kind == 'error_free'
                          else 'spfl')
    rows = mesh.rows(k)
    label = f'{kind} K={k}'
    if kind == 'error_free':
        fl = FLConfig(n_devices=k, wire='packed')
        want, tw = tr.error_free_aggregate(grads, fl, draws, round_idx=5)
        got, tg = tr.error_free_aggregate(grads[rows], fl, draws,
                                          round_idx=5, collective='sharded',
                                          mesh=mesh, k=k)
        atol = ulp_bound(torch.ones(k), grads.abs().amax(1), 0.0) / k
    else:
        kw = dict(n_retx=n_retx, wire='packed', round_idx=5,
                  channel='bitlevel')
        want, tw = tr.spfl_aggregate(grads, gbar, q, p, BITS, 32, draws,
                                     **kw)
        got, tg = tr.spfl_aggregate(grads[rows], gbar, q, p, BITS, 32,
                                    draws, collective='sharded', mesh=mesh,
                                    **kw)
        q_eff = 1.0 - (1.0 - q) ** (n_retx + 1)
        atol = ulp_bound(1.0 / q_eff, grads.abs().amax(1),
                         float(gbar.max())) / k
    chk.f32(label, got, want, atol)
    chk.telemetry(label, tg, tw)
    chk.same_bits(label, got)
    flips = (0 if tw.sign_flips is None
             else int(tw.sign_flips.sum() + tw.mod_flips.sum()))
    return {'flips': flips, 'sign_ok': int(tw.sign_ok.sum())}


def shard_tree(chk, kind: str, k: int, seed: int) -> dict:
    """The tree transport (spfl bit-level, or error_free) over the CNN's
    parameter tree at K clients, gathered and sharded."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import transport as tr
    from repro_torch.models import cnn
    mesh, dev = chk.mesh, torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = {key: cnn._LEAVES[key][1] for key in cnn.KEYS}
    grads = {n: torch.randn((k,) + tuple(s), generator=gen, device=dev)
             * 0.05 for n, s in shapes.items()}
    gbar = {n: torch.rand(tuple(s), generator=gen, device=dev) * 0.05
            for n, s in shapes.items()}
    q = 0.55 + 0.44 * torch.rand((k,), generator=gen, device=dev)
    p = 0.55 + 0.44 * torch.rand((k,), generator=gen, device=dev)
    sizes = [int(x[0].numel()) for x in tree.leaves(grads)]
    draws = tr.make_tree_draws(k, sizes, 0, 'bitlevel', dev, gen,
                               torch.Generator().manual_seed(seed), kind=kind)
    draws = draws._replace(rand=list(draws.rand))
    fl = FLConfig(n_devices=k, wire='packed', channel='bitlevel')
    mine = tree.map(lambda g: g[mesh.rows(k)], grads)
    label = f'tree {kind} K={k}'
    if kind == 'error_free':
        want, sw, tw = tr.error_free_aggregate_tree(grads, fl, draws)
        got, sg, tg = tr.error_free_aggregate_tree(
            mine, fl, draws, collective='sharded', mesh=mesh, k=k)
        weight, gmax_bar = torch.ones(k) / k, 0.0
    else:
        want, sw, tw = tr.spfl_aggregate_tree(grads, gbar, q, p, fl, draws)
        got, sg, tg = tr.spfl_aggregate_tree(mine, gbar, q, p, fl, draws,
                                             collective='sharded', mesh=mesh)
        weight = 1.0 / q / k
        gmax_bar = max(float(x.max()) for x in tree.leaves(gbar))
    for f in ('g_min', 'g_max'):
        chk.ints(f'{label}.{f}', sg[f], sw[f])
    chk.rel(f'{label}.g2', sg['g2'], sw['g2'], G2_RTOL)
    atol = ulp_bound(weight, sw['g_max'], gmax_bar)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        chk.f32(label, a, b, atol)
        chk.same_bits(label, a)
    chk.telemetry(label, tg, tw)
    return {'sign_ok': int(tw.sign_ok.sum())}


def shard_votes(chk, k: int, n: int, seed: int) -> dict:
    """``ops.spfl_aggregate_packed_sharded`` at K clients: the sum and,
    where a rank's block fits a 32-client vote word, the votes (the
    integer sum of each block's gathered votes; the gathered call over
    K > 32 has none)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.wire import format as fmt
    mesh, dev = chk.mesh, torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    groups = fmt.n_groups(n)

    def words(shape):
        return fmt.to_words(torch.randint(0, 2 ** 32, shape, generator=gen,
                                          device=dev))

    sp, qp = words((k, groups)), words((k, groups * BITS))
    gbar = torch.rand((n,), generator=gen, device=dev)
    gmin = torch.rand((k,), generator=gen, device=dev) * 0.1
    gmax = gmin + torch.rand((k,), generator=gen, device=dev)
    mod_ok = torch.rand((k,), generator=gen, device=dev) < 0.7
    w = torch.rand((k,), generator=gen, device=dev) * 2.0
    sign_ok = torch.rand((k,), generator=gen, device=dev) < 0.8
    want, votes = ops.spfl_aggregate_packed(sp, qp, gbar, gmin, gmax, mod_ok,
                                            w, sign_ok, n, BITS)
    blk = [mesh.block(x, k) for x in (sp, qp, gmin, gmax, mod_ok, w,
                                      sign_ok)]
    got, got_votes = ops.spfl_aggregate_packed_sharded(
        blk[0], blk[1], gbar, *blk[2:], n, BITS, mesh=mesh)
    label = f'votes K={k}'
    chk.f32(label, got, want, ulp_bound(w, gmax, float(gbar.max())))
    kb = mesh.k_local(k)
    if kb <= ops.MAX_VOTE_CLIENTS:
        parts = [ops.spfl_aggregate_packed(
            sp[r * kb:(r + 1) * kb], qp[r * kb:(r + 1) * kb], gbar,
            gmin[r * kb:(r + 1) * kb], gmax[r * kb:(r + 1) * kb],
            mod_ok[r * kb:(r + 1) * kb], w[r * kb:(r + 1) * kb],
            sign_ok[r * kb:(r + 1) * kb], n, BITS)[1]
            for r in range(mesh.size) if r * kb < k]
        votes = sum(parts)
    chk.ints(label, got_votes, votes)
    chk.same_bits(label, got)
    return {'votes': got_votes is not None}


def sharded_cases(mesh) -> dict:
    """Phase 12's first part on this rank: the flat transports (spfl,
    spfl_retx, error_free; packed, bit-level) at the main path's width
    (K=20, l=62,006) and the tree transports over the CNN's parameter
    tree, then K=5 (the ragged padding) and the sum and votes of K=40
    clients (32 a shard), each sharded against the gathered call on the
    same inputs.  -> {'cases': per case max f32 error and bound, 'info',
    'counts': this rank's launches}."""
    import torch
    from repro_torch.kernels import ops
    l_main = 62006
    chk = ShardCheck(mesh)
    info = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for i, kind in enumerate(('spfl', 'spfl_retx', 'error_free')):
        info[f'{kind} K={K}'] = shard_flat(chk, kind, K, l_main, 60 + i)
    info['tree spfl'] = shard_tree(chk, 'spfl', K, 63)
    info['tree error_free'] = shard_tree(chk, 'error_free', K, 64)
    info['spfl K=5'] = shard_flat(chk, 'spfl', 5, l_main, 65)
    info['tree spfl K=5'] = shard_tree(chk, 'spfl', 5, 66)
    info['votes K=40'] = shard_votes(chk, 40, l_main, 67)
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    return {'cases': chk.cases, 'info': info, 'counts': counts}


def sharded_llm_steps(mesh, steps: int = 2) -> dict:
    """Phase 12's second part on this rank (S = 2): ``steps`` smollm-135m
    steps at full width (K=4 clients of 8 x 256 tokens, packed,
    bit-level) with ``collective='sharded'``, this rank's two clients
    vmapped.  Losses and ĝ the same bits on both ranks.  On rank 0, the
    gathered step given the same gradients (each rank's clients' pass,
    concatenated) and draws: losses, verdicts, flips and bits equal, ĝ
    within S x the bound; and the gathered step of the 4-client pass (a
    batched bf16 pass over 4 clients rounds otherwise than one over 2):
    its losses, ||g_k||^2 and max |g_k| within ``VMAP_RTOL``.  Each step
    starts both from the sharded run's state."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import transport as tr
    from repro_torch.data import synth_tokens
    from repro_torch.training import distributed as dist
    cfg = get_arch(LLM_ARCH)
    params = llm_params(cfg, seed=21)
    toks = torch.as_tensor(synth_tokens(LLM_K * 8, 256, cfg.vocab_size, 21)
                           .reshape(LLM_K, 8, 256), device='cuda')
    fl = FLConfig(n_devices=LLM_K, learning_rate=LLM_RUN['lr'],
                  bandwidth_hz=LLM_RUN['bandwidth_hz'], wire='packed',
                  channel='bitlevel')
    # deterministic gradients: rank 0 recomputes rank 1's clients' pass
    step_4 = dist.make_fl_train_step(cfg, fl, deterministic=True)
    step_s = dist.make_fl_train_step(
        cfg, dataclasses.replace(fl, collective='sharded'), mesh=mesh,
        deterministic=True)
    q = torch.tensor([0.55, 0.7, 0.85, 1.0], device='cuda')
    p = torch.tensor([0.9, 0.6, 0.75, 0.95], device='cuda')
    sizes = [int(x.numel()) for x in tree.leaves(params)]
    kb = mesh.k_local(LLM_K)
    chk = ShardCheck(mesh)
    p_s, g_s = params, dist.init_gbar(params)
    out = {'step_ms': []}

    def draws(n):
        return tr.make_tree_draws(
            LLM_K, sizes, 0, 'bitlevel', 'cuda',
            torch.Generator(device='cuda').manual_seed(70 + n),
            torch.Generator().manual_seed(70 + n))

    for n in range(steps):
        label = f'llm step {n}'
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_n, g_n, ms = step_s(p_s, {'tokens': toks[mesh.rows(LLM_K)]}, g_s,
                              q, p, draws(n))
        torch.cuda.synchronize()
        out['step_ms'].append((time.perf_counter() - t0) * 1e3)
        chk.same_bits(f'{label} loss', ms['loss'])
        for leaf in tree.leaves(g_n):
            chk.same_bits(f'{label} ghat', leaf)
        if mesh.rank == 0:
            parts = [dist.client_grads(p_s, cfg, toks[r * kb:(r + 1) * kb],
                                       deterministic=True)
                     for r in range(mesh.size)]
            losses = torch.cat([x[0] for x in parts])
            grads = tree.unflatten(p_s, [
                torch.cat(ls) for ls in zip(*(tree.leaves(x[1])
                                              for x in parts))])
            del parts
            ghat, sw, tw = tr.spfl_aggregate_tree(grads, g_s, q, p, fl,
                                                  draws(n))
            del grads
            chk.telemetry(label, ms['telemetry'], tw)
            chk.ints(f'{label}.losses', ms['client_losses'], losses)
            chk.ints(f'{label}.loss', ms['loss'], torch.mean(losses))
            for f in ('g_min', 'g_max'):
                chk.ints(f'{label}.{f}', ms[f], sw[f])
            chk.rel(f'{label}.g2', ms['g_norm_sq'], sw['g2'], G2_RTOL)
            gb_max = max(float(x.max()) for x in tree.leaves(g_s))
            atol = ulp_bound(1.0 / q / LLM_K, sw['g_max'], gb_max)
            for a, b in zip(tree.leaves(g_n), tree.leaves(ghat)):
                chk.f32(label, a, torch.abs(b), atol)
            del ghat
            # the 4-client pass's step
            _, _, m4 = step_4(p_s, {'tokens': toks}, g_s, q, p, draws(n))
            for f in ('client_losses', 'g_norm_sq', 'g_max'):
                chk.rel(f'{label} vmap4.{f}', ms[f], m4[f], VMAP_RTOL,
                        exact_at_one=False)
            del m4
        p_s, g_s = p_n, g_n
    out['cases'] = chk.cases
    return out


def shard_rank_main(rank: int, world: int, port: int, out: str) -> int:
    """A rank of the phase's gloo runs (``python3 chip_smoke.py
    --shard-rank R S PORT OUT``): the sharded cases, and at S = 2 the LLM
    steps; writes its results to OUT/rankR.json."""
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    build.build()
    tdist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                             rank=rank, world_size=world)
    try:
        res = sharded_cases(make_host_mesh())
        if world == 2:
            res['llm'] = sharded_llm_steps(make_host_mesh())
        torch.cuda.synchronize()
        Path(out, f'rank{rank}.json').write_text(json.dumps(res))
    finally:
        tdist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def spawn_ranks(world: int) -> list:
    """``world`` gloo ranks of this script on the one card -> each rank's
    results; a rank that fails fails the phase (the others are
    stopped)."""
    import tempfile
    out = tempfile.mkdtemp(prefix=f'shard{world}_', dir=ROOT / 'build')
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), '--shard-rank',
         str(r), str(world), str(port), out],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errors = []
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=SHARD_TIMEOUT_S)
            if proc.returncode:
                errors.append(f'rank {r} exit {proc.returncode}: '
                              f'{err[-3000:]}')
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        raise AssertionError(f'S={world} gloo ranks failed:\n'
                             + '\n'.join(errors))
    return [json.loads(Path(out, f'rank{r}.json').read_text())
            for r in range(world)]


def print_shard(label: str, res: dict) -> None:
    worst = {c: f'{v["max_err"]:.3e} (bound {v["bound"]:.3e})'
             for c, v in res['cases'].items()}
    print(f'{label}: integers bit for bit, every rank the same bits, f32 '
          f'{json.dumps(worst)}; {json.dumps(res["info"])}', flush=True)


def run_sharded() -> dict:
    """Phase 12's sharded collective: S = 1 over NCCL in this process,
    then S = 2 and 4 gloo ranks as processes on the one card (NCCL takes
    one rank a card), each against the gathered calls; at S = 2 also two
    sharded smollm-135m steps.  -> launches by kernel (every rank)."""
    import torch
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    tdist.init_process_group('nccl', init_method='tcp://127.0.0.1:'
                             f'{free_port()}', rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        if (mesh.size, mesh.backend, mesh.capturable) != (1, 'nccl', True):
            raise AssertionError(f'the NCCL mesh is {mesh}')
        one = sharded_cases(mesh)
    finally:
        tdist.destroy_process_group()
    print_shard(f'sharded S=1 (NCCL, {time.perf_counter() - t0:.3f} s)',
                one)
    counts = dict(one['counts'])
    llm = None
    for world in SHARD_WORLDS:
        t0 = time.perf_counter()
        ranks = spawn_ranks(world)
        print_shard(f'sharded S={world} (gloo on the card, '
                    f'{time.perf_counter() - t0:.3f} s, rank 0)', ranks[0])
        for r in ranks:
            for name, c in r['counts'].items():
                counts[name] = counts.get(name, 0) + c
        if world == 2:
            llm = ranks[0]['llm']
    print(f'sharded smollm-135m steps (S=2 gloo, K={LLM_K} clients of 8 x '
          f'256 tokens, packed, bit-level): step ms '
          f'{json.dumps(llm["step_ms"])}; against the gathered step on '
          f'the same gradients and the 4-client pass\'s step (vmap4, '
          f'relative) {json.dumps(llm["cases"])}', flush=True)
    return {'counts': counts, 'llm': llm}


def stack_device_problems(probs):
    import torch
    from repro_torch.core import allocation_jax as AJ
    return AJ.JaxAllocationProblem(*(
        torch.stack([getattr(p, f) for p in probs])
        for f in AJ.PER_CLIENT + AJ.SCALARS))


def keep_f32_solves(kept: list):
    """Keep each float32 ``ops.alloc_solve`` call's problem, options and
    solution (inside a graph: the tensors its replays rewrite) by
    wrapping the function the fused round calls.  -> the undo."""
    import torch
    from repro_torch.kernels import ops
    orig = ops.alloc_solve

    def wrapped(prob, method='alternating', max_iters=6, tol=1e-5,
                n_grid=256, newton_iters=40, early_exit=True, inner_tol=0.0,
                gate=None, trips=None):
        sol = orig(prob, method, max_iters, tol, n_grid, newton_iters,
                   early_exit, inner_tol, gate, trips)
        if prob.A.dtype == torch.float32:
            kept.append(dict(prob=prob, method=method, max_iters=max_iters,
                             tol=tol, early_exit=early_exit, gate=gate,
                             sol=sol))
        return sol

    ops.alloc_solve = wrapped
    return lambda: setattr(ops, 'alloc_solve', orig)


def check_kept_f32(kept: list, label: str) -> float:
    """Each kept float32 solve against its plain version on the same card
    tensors, bit for bit, as one batch (the plain solver is lane-stable:
    a batch equals its single solves).  -> the plain solve's seconds."""
    import torch
    from repro_torch.core import allocation_jax as AJ
    snap = [dict(s, prob=AJ.JaxAllocationProblem(*(
        None if x is None else x.clone() for x in s['prob'])),
        gate=None if s['gate'] is None else s['gate'].clone(),
        sol=AJ.JaxAllocation(*(x.clone() for x in s['sol'])))
        for s in kept]
    first = snap[0]
    if any((s['method'], s['max_iters'], s['tol'], s['early_exit'])
           != (first['method'], first['max_iters'], first['tol'],
               first['early_exit']) for s in snap):
        raise AssertionError(f'{label}: the kept solves differ in options')
    batch = stack_device_problems([s['prob'] for s in snap])
    gate = (None if first['gate'] is None else
            torch.stack([s['gate'].reshape(()) for s in snap]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = AJ.solve_plain(batch, first['method'],
                           max_iters=first['max_iters'], tol=first['tol'],
                           early_exit=first['early_exit'], gate=gate)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for i, s in enumerate(snap):
        same_solution(s['sol'], AJ.JaxAllocation(*(x[i] for x in plain)),
                      f'{label} solve {i}')
    return plain_s


def free_card() -> None:
    """Drop what the last run left to the collector and the allocator's
    cache: a 4-round smollm-135m graph takes ~30 GiB of its own pool,
    which a capture cannot free memory for."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def fused_llm_run(mode: str, guard=None, sink=None, **kw) -> dict:
    """``launch.train.run`` of smollm-135m at full width in fused rounds
    (``LLM_FUSED``: six rounds in segments of 4 and 2, barrier, 'jax')
    -> its history, wall seconds and launch counts (a captured launch
    counts once, at its capture)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    free_card()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.run(LLM_ARCH, round_fusion=mode, segment_guard=guard,
                     telemetry_path=sink, **{**LLM_FUSED, **kw})
    torch.cuda.synchronize()
    return dict(hist=hist, s=time.perf_counter() - t0,
                counts=dict(ops.launch_counts),
                gib=(before / 2 ** 30,
                     torch.cuda.max_memory_allocated() / 2 ** 30))


def sink_rows(path: str) -> list:
    from repro_torch.obs import read_jsonl
    _, rows = read_jsonl(path)
    return [{k: v for k, v in r.items() if k != 'step_s'} for r in rows]


def run_llm_fused(host_step_ms) -> dict:
    """Phase 12's fused LLM rounds and population mode: smollm-135m at
    full width, K=4, barrier, six rounds in segments of 4 and 2 under
    'eager' and under 'scan', each run twice (the first 'eager' run under
    sync debug mode 'error', the first 'scan' run keeping each round's
    float32 problem, the second 'scan' run under ``torch.profiler``):
    'scan' = 'eager' bit for bit (losses, (q, p), telemetry rows); each
    ``alloc_solve_f32`` = its plain version bit for bit; fused error_free
    = the host loop (deterministic) bit for bit; then one population
    'scan' segment (N = 10^6, cohort 4) whose cohort ids are the host
    chain's.  ``host_step_ms``: phase 11's host-loop steps, this call."""
    import tempfile
    import torch
    from repro_torch import population as pop
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import threefry
    out = {}
    tmp = tempfile.mkdtemp(prefix='llm_fused_', dir=ROOT / 'build')
    sync = Watch('sync')
    runs = {('eager', 0): fused_llm_run('eager', sync,
                                        f'{tmp}/eager0.jsonl')}
    if len(sync.launches) != 3:
        raise AssertionError('eager: the sync guard saw '
                             f'{len(sync.launches)} launches, want the '
                             'warm-up round and two segments')
    runs[('eager', 1)] = fused_llm_run('eager', sink=f'{tmp}/eager1.jsonl')
    kept = []
    undo = keep_f32_solves(kept)
    try:
        runs[('scan', 0)] = fused_llm_run('scan', sink=f'{tmp}/scan0.jsonl')
    finally:
        undo()
    prof = Watch('profile')
    runs[('scan', 1)] = fused_llm_run('scan', prof, f'{tmp}/scan1.jsonl')
    ref = runs[('eager', 0)]
    for key, r in runs.items():
        h = r['hist']
        for f in ('loss', 'q', 'p'):
            if h[f] != ref['hist'][f]:
                raise AssertionError(f'fused llm {key}: {f} {h[f]} != '
                                     f'{ref["hist"][f]}')
        if sink_rows(f'{tmp}/{key[0]}{key[1]}.jsonl') != sink_rows(
                f'{tmp}/eager0.jsonl'):
            raise AssertionError(f'fused llm {key}: telemetry rows differ')
        if not all(math.isfinite(x) for x in h['loss']):
            raise AssertionError(f'fused llm {key}: loss {h["loss"]}')
    if not any(q != 1.0 for q in ref['hist']['q'][1:]):
        raise AssertionError('fused llm: every solve took the uniform point')
    # the kept solves: the warm-up round's, then the graphs' six rounds
    if len(kept) != 1 + LLM_FUSED['steps']:
        raise AssertionError(f'fused llm: {len(kept)} float32 solves kept')
    plain_s = check_kept_f32(kept[1:], 'fused llm alloc_solve_f32')
    del kept
    print(f'fused llm alloc_solve_f32 ({LLM_RUN["allocator"]}, K={LLM_K}): '
          f'{LLM_FUSED["steps"]} rounds\' solves = their plain version bit '
          f'for bit (one plain batch, {plain_s:.3f} s on the card)',
          flush=True)
    for key, r in runs.items():
        h = r['hist']
        steady = [(s - c) * 1e3 for s, c in zip(h['step_s'],
                                                h['capture_s'])]
        print(f'fused llm {key[0]} run {key[1]}: {r["s"]:.3f} s (set-up '
              f'included); round ms {json.dumps(steady)} (less graph '
              f'capture, {sum(h["capture_s"]):.3f} s; segment 1 holds the '
              f'warm-up round); launches at capture '
              f'{json.dumps({n: c for n, c in r["counts"].items() if c})}; '
              f'GiB allocated before / peak {r["gib"][0]:.3f} / '
              f'{r["gib"][1]:.3f}', flush=True)
    # steady: the rounds after the first segment (its warm-up round and
    # first draws), less their graph's capture, of the unprofiled runs
    steady = {mode: [(s - c) * 1e3 for s, c in zip(
        runs[run]['hist']['step_s'], runs[run]['hist']['capture_s'])][
            LLM_FUSED['scan_segment_rounds']:]
        for mode, run in (('eager', ('eager', 1)), ('scan', ('scan', 0)))}
    seg = prof.launches[1]               # [0] is the warm-up round
    kinds = op_kinds(seg['names'])
    print(f'fused llm scan segment 1 (4 rounds, one graph; torch.profiler):'
          f' wall {seg["wall_ms"]:.3f} ms, device busy {seg["busy_ms"]:.3f}'
          f' ms (idle share {1 - seg["busy_ms"] / seg["wall_ms"]:.4f}); '
          f'the card ran {json.dumps(kinds)}; top '
          f'{json.dumps(seg["top_ms"])}', flush=True)
    want = {'quantize_pack': 44, 'spfl_accumulate': 44,
            'alloc_solve_f32': 4}
    if {n: kinds.get(n, 0) for n in want} != want:
        raise AssertionError(f'fused llm scan segment: the card ran {kinds},'
                             f' want {want}')
    print(f'fused llm vs host loop (phase 11, this call): fused steady '
          f'round ms {json.dumps(steady)}; host-loop step ms '
          f'{json.dumps(host_step_ms)}', flush=True)
    out.update(steady=steady, idle=1 - seg['busy_ms'] / seg['wall_ms'],
               counts=runs[('scan', 0)]['counts'], plain_s=plain_s,
               segment=seg, kinds=kinds)
    # fused error_free = the host loop, bit for bit
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    ef = dict(LLM_FUSED, transport_kind='error_free')
    free_card()
    host = train.run(LLM_ARCH, deterministic=True, **ef)
    fused = fused_llm_run('scan', transport_kind='error_free')['hist']
    if host['loss'] != fused['loss']:
        raise AssertionError(f'fused error_free {fused["loss"]} != host '
                             f'loop {host["loss"]}')
    print(f'fused llm error_free = host loop bit for bit: losses '
          f'{json.dumps(host["loss"])}', flush=True)
    # one population segment: its cohorts are the host chain's
    path = f'{tmp}/pop.jsonl'
    pop_run = fused_llm_run('scan', sink=path, steps=4, **LLM_POP)
    rows = sink_rows(path)
    fl = FLConfig(n_devices=LLM_K, **LLM_POP)
    streams = pop.stream_keys(pop.population_key(fl.seed))
    chain = threefry.fold_in(threefry.key(fl.seed), train.CHAIN_FOLD)
    for n, row in enumerate(rows):
        chain, kr = threefry.split(chain)
        want_ids = pop.draw_cohort(kr, streams, fl, n, gains=False).cohort.ids
        if row['cohort_ids'] != want_ids.tolist():
            raise AssertionError(f'population round {n}: cohort '
                                 f'{row["cohort_ids"]} != {want_ids}')
    print(f'fused llm population (N = 10^6, cohort {LLM_K}, one scan '
          f'segment of 4): cohort ids = the host chain\'s: '
          f'{[r["cohort_ids"] for r in rows]}; loss '
          f'{json.dumps(pop_run["hist"]["loss"])}', flush=True)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return out


# ---------------------------------------------------------------------------
# phase 13: the rest of the model zoo, prefill/decode and serving
# ---------------------------------------------------------------------------

# launch.train.run's knobs for the zoo's FL steps: packed, bit-level,
# barrier, 'jax' (the launcher's other defaults, as LLM_RUN)
ZOO_RUN = dict(LLM_RUN, channel='bitlevel')
# the zoo run at full width, cut in depth to one group of their pattern
ZOO_ONE_GROUP = ('zamba2-2.7b', 'paligemma-3b', 'musicgen-medium')
ZOO_SERVE = dict(batch=4, prompt_len=128)
# a float32 model's decode against its float32 forward: of each row's
# largest |logit|
F32_SERVE_RTOL = 1e-4
# the kernels phase 13's paths launch, each of which must
PHASE13_KERNELS = ('quantize_pack', 'spfl_accumulate', 'corrupt_fold',
                   'alloc_solve', 'alloc_solve_f32')


def one_group(name: str):
    """``name`` at full width with its depth cut to one group of its
    layer pattern (mixtral-8x7b: 32 -> 1 layers, 1,713,418,240
    parameters; zamba2-2.7b: 54 -> 6, the shared block once,
    468,146,480; paligemma-3b: 18 -> 1, 639,244,288; musicgen-medium:
    48 -> 1, 44,044,800)."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(name)
    return dataclasses.replace(cfg, n_layers=len(cfg.layer_pattern))


def n_leaves(cfg) -> int:
    """The leaves of ``cfg``'s parameter tree, counted on the meta
    device (no memory, no draws)."""
    import torch
    from repro_torch import tree
    from repro_torch.models import transformer as tf
    return len(tree.leaves(tf.init_params(cfg, torch.Generator(),
                                          device='meta')))


def zoo_counts(counts: dict, launched: dict) -> None:
    for name, c in counts.items():
        launched[name] = launched.get(name, 0) + c


def zoo_train(label: str, arch, steps: int, launched: dict, **kw) -> dict:
    """``launch.train.run`` of ``arch`` in the host loop (``ZOO_RUN``),
    counters reset just before and read just after: per step one
    ``quantize_pack`` and one ``spfl_accumulate`` a leaf, two
    ``corrupt_fold`` a leaf (modulus and sign passes), one
    ``alloc_solve`` a step from step 1, nothing else, the leaves counted
    from the configuration (``n_leaves``); finite losses, q in (0, 1],
    p in [0, 1]."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    leaves = n_leaves(get_arch(arch) if isinstance(arch, str) else arch)
    free_card()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.run(arch, steps=steps, **{**ZOO_RUN, **kw})
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    counts = {n: c for n, c in ops.launch_counts.items() if c}
    zoo_counts(counts, launched)
    want = {'quantize_pack': leaves * steps, 'spfl_accumulate':
            leaves * steps, 'corrupt_fold': 2 * leaves * steps}
    if steps > 1:
        want['alloc_solve'] = steps - 1
    if counts != want:
        raise AssertionError(f'{label}: launches {counts}, want {want}')
    if not (all(math.isfinite(x) for x in hist['loss'])
            and all(0.0 < q <= 1.0 for q in hist['q'])
            and all(0.0 <= p <= 1.0 for p in hist['p'])):
        raise AssertionError(f'{label}: loss {hist["loss"]}, q {hist["q"]},'
                             f' p {hist["p"]}')
    print(f'{label}: {s:.3f} s (set-up included), {leaves} leaves; step ms '
          f'{json.dumps([t * 1e3 for t in hist["step_s"]])}; loss '
          f'{json.dumps(hist["loss"])}; q̄ {json.dumps(hist["q"])}; p̄ '
          f'{json.dumps(hist["p"])}; launches {json.dumps(counts)}',
          flush=True)
    return dict(hist=hist, s=s, counts=counts)


def zoo_prefix_step(label: str, cfg, launched: dict) -> None:
    """One bit-level ``make_fl_train_step`` step of a vision model given
    the bf16 prefix batch ``client_batch_shapes`` makes (K = 2 clients of
    2 x 32 tokens), with the counters reset just before and read just
    after; then the standard and eval steps on client 0's batch."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import transport as tr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.training import distributed as dist
    free_card()
    gen = torch.Generator(device='cuda').manual_seed(13)
    params = tf.init_params(cfg, gen, device='cuda')
    shapes = dist.client_batch_shapes(cfg, 2, 4, 32)
    batch = {'tokens': torch.randint(0, cfg.vocab_size, shapes['tokens'][0],
                                     generator=gen, device='cuda',
                                     dtype=torch.int32),
             'prefix': torch.randn(shapes['prefix'][0], generator=gen,
                                   device='cuda').to(shapes['prefix'][1])}
    fl = FLConfig(n_devices=2, wire='packed', channel='bitlevel',
                  learning_rate=0.05)
    sizes = [int(x.numel()) for x in tree.leaves(params)]
    draws = tr.make_tree_draws(2, sizes, 0, fl.channel, 'cuda', gen,
                               torch.Generator().manual_seed(13))
    q = torch.tensor([0.9, 1.0], device='cuda')
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    new, _, m = dist.make_fl_train_step(cfg, fl)(
        params, batch, dist.init_gbar(params), q, torch.ones(2,
                                                             device='cuda'),
        draws)
    torch.cuda.synchronize()
    counts = {n: c for n, c in ops.launch_counts.items() if c}
    zoo_counts(counts, launched)
    L = len(sizes)
    want = {'quantize_pack': L, 'spfl_accumulate': L, 'corrupt_fold': 2 * L}
    if counts != want:
        raise AssertionError(f'{label} prefix step: launches {counts}, want '
                             f'{want}')
    if not all(bool(torch.isfinite(x).all()) for x in tree.leaves(new)):
        raise AssertionError(f'{label} prefix step: non-finite parameters')
    one = {'tokens': batch['tokens'][0], 'prefix': batch['prefix'][0]}
    _, sm = dist.make_standard_train_step(cfg, fl)(params, one)
    ev = float(dist.make_eval_step(cfg)(params, one))
    if not abs(float(sm['loss']) - ev) <= 1e-5 * abs(ev):
        raise AssertionError(f'{label}: standard step loss {sm["loss"]} != '
                             f'eval {ev}')
    print(f'{label} step given a bf16 prefix batch {shapes["prefix"][0]}: '
          f'client losses {m["client_losses"].tolist()}, launches '
          f'{json.dumps(counts)}; standard step loss {float(sm["loss"]):.6f}'
          f' = eval step', flush=True)


def zoo_standard_step(name: str) -> None:
    """The plain data-parallel step of ``name`` on the card (the
    reference's step where per-client gradients do not exist at scale)."""
    import torch
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.training import distributed as dist
    cfg = get_arch(name)
    gen = torch.Generator(device='cuda').manual_seed(14)
    params = tf.init_params(cfg, gen, device='cuda')
    toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                         device='cuda')
    _, sm = dist.make_standard_train_step(cfg, FLConfig())(
        params, {'tokens': toks})
    if not (math.isfinite(float(sm['loss']))
            and float(sm['g_norm_sq']) > 0):
        raise AssertionError(f'{name} standard step: {sm}')
    print(f'{name} standard step: loss {float(sm["loss"]):.6f}, ||g||^2 '
          f'{float(sm["g_norm_sq"]):.6e}', flush=True)


def zoo_fused(label: str, arch, launched: dict, **kw) -> dict:
    """One 'scan' segment of 2 rounds and the same 2 rounds under 'eager'
    (``launch.train.run``, ``ZOO_RUN``), each with its warm-up round and
    segment launches under sync debug mode 'error' (``Watch('sync')``):
    'scan' = 'eager' bit for bit (losses, q, p)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    runs = {}
    for mode in ('eager', 'scan'):
        free_card()
        ops.reset_launch_counts()
        sync = Watch('sync')
        t0 = time.perf_counter()
        hist = train.run(arch, steps=2, round_fusion=mode,
                         scan_segment_rounds=2, segment_guard=sync,
                         **{**ZOO_RUN, **kw})
        torch.cuda.synchronize()
        counts = {n: c for n, c in ops.launch_counts.items() if c}
        zoo_counts(counts, launched)
        runs[mode] = hist
        if len(sync.launches) != 2:
            raise AssertionError(f'{label} {mode}: the sync guard saw '
                                 f'{len(sync.launches)} launches')
        if not counts.get('alloc_solve_f32'):
            raise AssertionError(f'{label} {mode}: launches {counts}')
        steady = [(s - c) * 1e3 for s, c in zip(hist['step_s'],
                                                hist['capture_s'])]
        print(f'{label} fused {mode}: {time.perf_counter() - t0:.3f} s '
              f'(set-up included); round ms less capture '
              f'{json.dumps(steady)}, capture '
              f'{sum(hist["capture_s"]):.3f} s; loss '
              f'{json.dumps(hist["loss"])}; launches at capture '
              f'{json.dumps(counts)}', flush=True)
    for f in ('loss', 'q', 'p'):
        if runs['scan'][f] != runs['eager'][f]:
            raise AssertionError(f'{label}: scan {f} {runs["scan"][f]} != '
                                 f'eager {runs["eager"][f]}')
    print(f'{label}: scan = eager bit for bit (losses, q, p), warm-up and '
          'segments under sync debug mode error', flush=True)
    return runs


def record_drops(drops: list):
    """Keep each MoE call's ``drop_frac`` (a device scalar) by wrapping
    the transformer's ``moe_forward``.  -> a callable that undoes it."""
    from repro_torch.models import transformer as tf
    orig = tf.moe_forward

    def wrapped(p, cfg, x):
        y, aux = orig(p, cfg, x)
        drops.append(aux['drop_frac'])
        return y, aux

    tf.moe_forward = wrapped
    return lambda: setattr(tf, 'moe_forward', orig)


def decode_logits(params, cfg, prompts, out, prefix=None):
    """The served run's logits replayed: the prefill's last (B, V), then
    one decode step a generated token but the last -> (B, n, V)."""
    import torch
    from repro_torch.models import transformer as tf
    P = 0 if prefix is None else prefix.shape[1]
    T = prompts.shape[1]
    n = out.shape[1]
    with torch.no_grad():
        logits, cache = tf.prefill(params, cfg, prompts, P + T + n + 8,
                                   prefix_embeds=prefix,
                                   cache_dtype=torch.float32)
        rows = [logits[:, 0]]
        for i in range(n - 1):
            logits, cache = tf.decode_step(params, cfg, cache, out[:, i:i + 1],
                                           P + T + i)
            rows.append(logits[:, 0])
    return torch.stack(rows, dim=1)


def served_forward(params, cfg, prompts, out):
    """The full-sequence logits that predict each served token (B, n, V),
    float32: the prompt's last position from a forward of the prompt
    alone (the prefill's tokens: an MoE drops the same ones), the decoded
    positions from a forward of prompt and output at a capacity no token
    exceeds (decode routes one token a row: B k assignments, never
    dropped)."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tf
    T = prompts.shape[1]
    full_cfg = (dataclasses.replace(cfg, capacity_factor=float(
        cfg.n_experts)) if cfg.is_moe else cfg)
    with torch.no_grad():
        h0, _ = tf.forward(params, cfg, prompts)
        first = tf.logits_fn(params, cfg, h0[:, -1:])
        seq = torch.cat([prompts, out[:, :-1].to(prompts.dtype)], dim=1)
        h1, _ = tf.forward(params, full_cfg, seq)
        rest = tf.logits_fn(params, full_cfg, h1[:, T:])
    return torch.cat([first, rest], dim=1).to(torch.float32)


def check_served(label: str, params, cfg, prompts, out) -> dict:
    """The served tokens fed back through the full-sequence ``forward``
    (``served_forward``) and through the same forward of a float32 copy
    of the weights: the decode logits are no farther from the float32
    model than the bf16 forward is, plus ``VMAP_RTOL`` of each position's
    largest |logit| (four bf16 ulps); the argmax is the forward's at
    every position whose top-two margin exceeds the decode's distance
    from it.  The decode-to-forward distance is printed against the four
    ulps too: the attention stacks attend over the float32 cache in the
    model's dtype, as the forward does; Mamba2's forward runs the bf16
    chunked scan (decay matrices rounded to bf16, as the reference's),
    its decode the exact recurrence on the float32 state.  The cache
    logic apart from bf16 rounding is held by ``check_served_f32``."""
    import dataclasses
    import torch
    from repro_torch import tree
    dec = decode_logits(params, cfg, prompts, out).to(torch.float32)
    full = served_forward(params, cfg, prompts, out)
    full32 = served_forward(tree.map(lambda a: a.to(torch.float32), params),
                            dataclasses.replace(cfg, param_dtype='float32'),
                            prompts, out)
    ulps = VMAP_RTOL * full.abs().amax(-1)
    d_fwd = (dec - full).abs().amax(-1)                     # (B, n)
    e_dec = (dec - full32).abs().amax(-1)
    e_fwd = (full - full32).abs().amax(-1)
    top2 = torch.topk(full, 2, dim=-1).values
    held = top2[..., 0] - top2[..., 1] > d_fwd
    same = torch.argmax(full, -1) == out.to(torch.int64)
    worst = float((e_dec / (e_fwd + ulps)).max())
    if worst > 1.0 or not bool(same[held].all()):
        raise AssertionError(
            f'{label}: decode vs the float32 model {worst:.4f} x the bf16 '
            f'forward\'s distance + 4 ulps; argmax differs at '
            f'{int((held & ~same).sum())} held positions')
    res = dict(d_fwd=float(d_fwd.max()), ulp_ratio=float((d_fwd / ulps)
                                                         .max()),
               e_fwd=float(e_fwd.max()), e_dec=float(e_dec.max()),
               worst=worst, held=int(held.sum()), positions=held.numel(),
               same_all=int(same.sum()))
    print(f'{label}: decode vs bf16 forward max |diff| {res["d_fwd"]:.6f} '
          f'({res["ulp_ratio"]:.4f} x four bf16 ulps of the row); vs the '
          f'float32 model: decode {res["e_dec"]:.6f}, bf16 forward '
          f'{res["e_fwd"]:.6f} (decode <= forward + 4 ulps: '
          f'{worst:.4f} of it); argmax equal at all {res["held"]} of '
          f'{res["positions"]} positions whose margin exceeds the '
          f'difference ({res["same_all"]} equal in all)', flush=True)
    return res


def check_served_f32(label: str, name: str, new_tokens: int = 8) -> dict:
    """A float32 copy of ``name`` at full width (``param_dtype=
    'float32'``, drawn from the same seed) served through
    ``launch.serve.run`` (batch 4, prompt 128, greedy) with TF32 off:
    every decode logit within ``F32_SERVE_RTOL`` of its row's largest
    |logit| from the float32 full-sequence forward (``served_forward``),
    and the argmax the forward's wherever the top-two margin exceeds
    that difference.  With float32 rounding on both sides a cache slot
    written wrong, stale or missing shows far above the bound."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    free_card()
    cfg = dataclasses.replace(get_arch(name), param_dtype='float32')
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = serve.run(cfg, new_tokens=new_tokens, device='cuda',
                        **ZOO_SERVE)
        out = res['output']
        dec = decode_logits(res['params'], cfg, res['prompts'], out)
        full = served_forward(res['params'], cfg, res['prompts'], out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    diff = (dec.to(torch.float32) - full).abs().amax(-1)     # (B, n)
    rel = float((diff / full.abs().amax(-1)).max())
    top2 = torch.topk(full, 2, dim=-1).values
    held = top2[..., 0] - top2[..., 1] > diff
    same = torch.argmax(full, -1) == out.to(torch.int64)
    if not (rel <= F32_SERVE_RTOL and bool(same[held].all())):
        raise AssertionError(
            f'{label}: float32 decode vs forward {rel:.3e} of the row\'s '
            f'largest |logit| (bound {F32_SERVE_RTOL}); argmax differs at '
            f'{int((held & ~same).sum())} held positions')
    print(f'{label} float32 served ({new_tokens} tokens): decode vs '
          f'float32 forward max |diff| {float(diff.max()):.3e}, '
          f'{rel:.3e} of the row\'s largest |logit| (bound '
          f'{F32_SERVE_RTOL}); argmax equal at {int(same.sum())} of '
          f'{same.numel()} ({int(held.sum())} held)', flush=True)
    del res
    return dict(rel=rel, max_abs=float(diff.max()), same=int(same.sum()),
                positions=same.numel())


def profile_decode(label: str, params, cfg, prompts, out) -> dict:
    """One decode step under ``torch.profiler`` (``card_profile``): its
    device operations, busy ms (the union of their intervals), wall ms
    and the device's idle share."""
    import torch
    from repro_torch.models import transformer as tf
    T, n = prompts.shape[1], out.shape[1]
    with torch.no_grad():
        _, cache = tf.prefill(params, cfg, prompts, T + n + 8,
                              cache_dtype=torch.float32)
        tf.decode_step(params, cfg, cache, out[:, :1], T)   # warm
        for _ in range(3):
            with card_profile() as prof:
                t0 = time.perf_counter()
                tf.decode_step(params, cfg, cache, out[:, :1], T)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            spans = [(e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            if spans:
                break
    busy = busy_ms(spans)
    res = dict(ops=len(spans), busy_ms=busy, wall_ms=wall,
               idle=1 - busy / wall)
    print(f'{label}: one decode step (torch.profiler): {res["ops"]} device '
          f'operations, busy {busy:.3f} of {wall:.3f} ms (idle share '
          f'{res["idle"]:.4f})', flush=True)
    return res


def zoo_serve(label: str, arch, new_tokens: int) -> dict:
    """``launch.serve.run`` on the card (batch 4, prompt 128, greedy):
    prefill ms, decode ms a token, tokens a second; one decode step
    profiled; the output held to the full forward (``check_served``);
    an MoE model's ``drop_frac`` per call."""
    import torch
    from repro_torch.launch import serve
    free_card()
    drops = []
    undo = record_drops(drops)
    try:
        res = serve.run(arch, new_tokens=new_tokens, device='cuda',
                        **ZOO_SERVE)
    finally:
        undo()
    out = res['output']
    if tuple(out.shape) != (ZOO_SERVE['batch'], new_tokens):
        raise AssertionError(f'{label}: output {tuple(out.shape)}')
    print(f'{label} served: prefill {res["prefill_ms"]:.3f} ms, decode '
          f'{res["decode_ms_per_token"]:.3f} ms a token, '
          f'{res["tokens_per_s"]:.1f} tokens/s ({res["seconds"]:.3f} s)',
          flush=True)
    if drops:
        print(f'{label}: drop_frac of the prefill '
              f'{float(drops[0]):.6f}, of the {len(drops) - 1} decode steps '
              f'{json.dumps(sorted({float(d) for d in drops[1:]}))}',
              flush=True)
    cfg = arch
    if isinstance(arch, str):
        from repro_torch.configs.registry import get_arch
        cfg = get_arch(arch)
    out_check = check_served(label, res['params'], cfg, res['prompts'], out)
    prof = profile_decode(label, res['params'], cfg, res['prompts'], out)
    del res['params']
    torch.cuda.empty_cache()
    return dict(prefill_ms=res['prefill_ms'],
                decode_ms=res['decode_ms_per_token'],
                tokens_per_s=res['tokens_per_s'], check=out_check,
                profile=prof,
                drops=[float(d) for d in drops])


def zoo_decode_equals_forward() -> float:
    """Every reduced architecture on the card: prefill of T - 1 tokens
    and one decode step == the full forward's last logits within the
    reference's 3e-3 (MoE at capacity 8, as the reference's test);
    gemma2 and mixtral with 80 tokens, past their 64-token window (the
    sliding-window rings have wrapped)."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import ARCHITECTURES, get_arch
    from repro_torch.models import transformer as tf
    worst = 0.0
    for name in sorted(ARCHITECTURES):
        cfg = get_arch(name + '-reduced')
        if cfg.is_moe:
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        T = 80 if cfg.sliding_window else 12
        gen = torch.Generator(device='cuda').manual_seed(15)
        params = tf.init_params(cfg, gen, device='cuda')
        toks = torch.randint(0, cfg.vocab_size, (2, T), generator=gen,
                             device='cuda')
        prefix = None
        if cfg.n_prefix_tokens:
            prefix = torch.randn((2, cfg.n_prefix_tokens,
                                  cfg.frontend_embed_dim), generator=gen,
                                 device='cuda')
        P = 0 if prefix is None else prefix.shape[1]
        with torch.no_grad():
            hidden, _ = tf.forward(params, cfg, toks, prefix)
            full = tf.logits_fn(params, cfg, hidden[:, -1:])
            _, cache = tf.prefill(params, cfg, toks[:, :-1], T + 4,
                                  prefix_embeds=prefix,
                                  cache_dtype=torch.float32)
            dec, _ = tf.decode_step(params, cfg, cache, toks[:, -1:],
                                    P + T - 1)
        err = float((full - dec).abs().max())
        worst = max(worst, err)
        if not err <= 3e-3:
            raise AssertionError(f'{name}-reduced: decode vs forward {err}')
        print(f'{name}-reduced decode vs forward on the card (T = {T}): max '
              f'|diff| {err:.3e}', flush=True)
    return worst


def run_zoo() -> dict:
    """Phase 13: the rest of the zoo's FL steps (bit-level, barrier,
    'jax'): mamba2-130m at full width and depth (K = 4 clients of 8 x 256
    tokens, 2 steps); at full width cut to one group of their pattern
    (``one_group``; K = 2 of 2 x 128) mixtral-8x7b (1 step), zamba2-2.7b,
    paligemma-3b (and a step given a bf16 prefix batch) and
    musicgen-medium (2 steps each); the reduced arctic (2 steps, and its
    standard step); one fused segment of 2 rounds, 'scan' and 'eager',
    on mamba2-130m and mixtral-8x7b-reduced; serving smollm-135m and
    mamba2-130m (32 new tokens) and mixtral-8x7b one layer (16) at full
    width, and float32 copies of smollm-135m and mamba2-130m (8); decode
    = forward on every reduced architecture.  -> the phase's launches by
    kernel and its figures."""
    import torch
    launched = {}
    out = {}
    mamba = dict(clients=LLM_K, batch=8, seq=256)
    out['mamba2'] = zoo_train('zoo mamba2-130m', 'mamba2-130m', 2, launched,
                              **mamba)
    wide = dict(clients=2, batch=2, seq=128)
    out['mixtral'] = zoo_train('zoo mixtral-8x7b (1 layer)',
                               one_group('mixtral-8x7b'), 1, launched, **wide)
    for name in ZOO_ONE_GROUP:
        cfg = one_group(name)
        layers = f'{cfg.n_layers} layer' + 's' * (cfg.n_layers > 1)
        out[name] = zoo_train(f'zoo {name} ({layers})', cfg, 2, launched,
                              **wide)
    small = dict(clients=2, batch=2, seq=32)
    zoo_train('zoo arctic-480b-reduced', 'arctic-480b-reduced', 2, launched,
              **small)
    zoo_standard_step('arctic-480b-reduced')
    zoo_prefix_step('paligemma-3b (1 layer)', one_group('paligemma-3b'),
                    launched)
    out['fused_mamba2'] = zoo_fused('zoo mamba2-130m', 'mamba2-130m',
                                    launched, **mamba)
    zoo_fused('zoo mixtral-8x7b-reduced', 'mixtral-8x7b-reduced', launched,
              **small)
    for key, arch, n in (('serve_smollm', 'smollm-135m', 32),
                         ('serve_mamba2', 'mamba2-130m', 32),
                         ('serve_mixtral', one_group('mixtral-8x7b'), 16)):
        label = arch if isinstance(arch, str) else 'mixtral-8x7b (1 layer)'
        out[key] = zoo_serve(f'serve {label}', arch, n)
    for name in ('smollm-135m', 'mamba2-130m'):
        out[f'serve_f32_{name}'] = check_served_f32(f'serve {name}', name)
    out['decode_worst'] = zoo_decode_equals_forward()
    missing = [n for n in PHASE13_KERNELS if not launched.get(n)]
    if missing:
        raise AssertionError(f'phase 13 launched no {missing}')
    print(f'phase 13 launches (graphs at capture): {json.dumps(launched)}',
          flush=True)
    free_card()
    torch.cuda.empty_cache()
    out['launched'] = launched
    return out


def kernel_bound(label: str, r: dict, sass_mix, name: str = None,
                 per_unit: dict = None):
    """(bound ms, 'bytes' or 'operations') of a launch that moves
    ``r['bytes']`` and does ``r['units']`` units of work of kernel
    ``name`` (default ``label``): the larger of the bytes over the HBM
    rate and the function's operations (``FUNCTION_OPS``, or
    ``per_unit`` where given) on the busiest resource.  Prints both, and
    the SASS of the build on the same units (``sass_mix``, per unit)
    beside them as a diagnostic."""
    from repro_torch.kernels import sass
    bytes_ms = r['bytes'] / HBM_BYTES_PER_S * 1e3
    ops = launch_mix(per_unit or FUNCTION_OPS[name or label], r['units'])
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
    # 11. the LLM-scale FL step on smollm-135m at full width
    t0 = time.perf_counter()
    llm = run_llm()
    print(f'phase 11: {time.perf_counter() - t0:.3f} s', flush=True)
    # 12. the sharded collective, fused LLM rounds and LLM population mode
    t0 = time.perf_counter()
    sharded = run_sharded()
    fused_llm = run_llm_fused(llm['step_ms'])
    launches12 = dict(sharded['counts'])
    for name, c in fused_llm['counts'].items():
        launches12[name] = launches12.get(name, 0) + c
    missing = [n for n in PHASE12_KERNELS if not launches12.get(n)]
    if missing:
        return fail(f'phase 12 launched no {missing}')
    print(f'phase 12 launches (every rank; graphs at capture): '
          f'{json.dumps({n: c for n, c in launches12.items() if c})}',
          flush=True)
    print(f'phase 12: {time.perf_counter() - t0:.3f} s', flush=True)
    # 13. the rest of the zoo, prefill/decode and serving
    t0 = time.perf_counter()
    zoo = run_zoo()
    print(f'phase 13: {time.perf_counter() - t0:.3f} s', flush=True)

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
            'bound_by': bound_by, 'library_ms': None,
            'phase12_launches': launches12.get(name, 0),
            'phase13_launches': zoo['launched'].get(name, 0)}
        if name in llm['rows']:
            v = llm['rows'][name]
            v_bound, v_by = kernel_bound(
                f'{name} (llm, {v["leaf"]} leaf)', v, None, name,
                NO_VOTE_OPS if name == 'spfl_accumulate' else None)
            row['llm'] = {
                'leaf': v['leaf'], 'k': v['k'], 'n': v['n'],
                'launches': llm['launches'][name],
                'max_abs_err': v['max_abs_err'], 'ms': v['ms'],
                'warm_ms': v['warm_ms'], 'plain_ms': v['plain_ms'],
                'bound_ms': v_bound, 'bound_by': v_by}
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
    # phase 12's fused LLM rounds and sharded steps run their gradient
    # pass under torch.use_deterministic_algorithms, which needs this
    # cuBLAS workspace setting before the process's first cuBLAS call
    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
    if len(sys.argv) > 1 and sys.argv[1] == '--shard-rank':
        sys.exit(shard_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                 int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
