"""Instruction mix of the built kernels, by Hopper execution pipe.

    python -m repro_torch.kernels.sass [--dump DIR]

builds the kernels (``kernels.build``), disassembles each library with
``cuobjdump -sass`` and prints, per kernel, its SASS instructions grouped
by the pipe that executes them: the straight-line code, and each loop
(a backward branch) on its own, with its nesting depth.  ``--dump`` also
writes each kernel's disassembly to ``DIR/<kernel>.sass``.

The pipes and their rates, in thread-instructions per clock per SM, are
those of compute capability 9.0 in the CUDA C++ Programming Guide's table
of arithmetic instruction throughput:

========  ====  =====================================================
pipe      rate  instructions
========  ====  =====================================================
fp32      128   FADD, FMUL, FFMA
imad      64    IMAD, IMUL (the multiply-add half of the FMA pipe)
alu       64    LOP3, SHF, IADD3, ISETP, SEL, LEA, PRMT, ... (INT32)
xu        16    I2F, F2I, POPC, FLO, BREV, MUFU (conversions, bit count)
fp64      64    DADD, DMUL, DFMA, DSETP (float64)
shfl      32    SHFL
other     --    memory, control, moves, uniform datapath: issue only
========  ====  =====================================================

An SM issues at most 4 warp-instructions per clock (128
thread-instructions), and fp32 and imad share the FMA pipe.  An
instruction whose pipe is not known here is counted as ``other``, so
:func:`bound_clocks` stays a lower bound.

Nothing here runs at import: the tests import every module on machines
without the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import os
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, List, Mapping, NamedTuple

PIPE_RATES = {'issue': 128, 'fp32': 128, 'imad': 64, 'alu': 64, 'xu': 16,
              'fp64': 64, 'shfl': 32}
_PIPES = {
    'fp32': ('FADD', 'FMUL', 'FFMA', 'FADD32I', 'FMUL32I', 'FFMA32I'),
    'imad': ('IMAD', 'IMUL', 'IMAD32I', 'IMUL32I', 'IDP'),
    'alu': ('LOP3', 'LOP', 'SHF', 'SHL', 'SHR', 'IADD3', 'IADD', 'ISETP',
            'ICMP', 'SEL', 'FSEL', 'FSETP', 'FMNMX', 'IMNMX', 'LEA', 'PRMT',
            'IABS', 'BMSK', 'SGXT', 'PLOP3', 'LOP32I', 'IADD32I'),
    'xu': ('I2F', 'F2I', 'I2FP', 'F2IP', 'F2F', 'I2I', 'FRND', 'POPC', 'FLO',
           'BREV', 'MUFU'),
    'fp64': ('DADD', 'DMUL', 'DFMA', 'DSETP', 'DMNMX'),
    'shfl': ('SHFL',),
}
PIPE_OF = {op: pipe for pipe, ops in _PIPES.items() for op in ops}

_FUNC = re.compile(r'Function\s*:\s*(\S+)')
_INSTR = re.compile(r'/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)'
                    r'([.A-Z0-9_]*)\s*([^;]*);')
_TARGET = re.compile(r'0x([0-9a-f]+)')


class Instr(NamedTuple):
    addr: int
    op: str          # base opcode, e.g. 'IMAD'
    text: str        # the whole instruction


class Region(NamedTuple):
    depth: int       # 0 = straight-line code, 1 = a loop, 2 = a loop in it
    start: int       # first address (the branch target of a loop)
    end: int         # last address (the backward branch of a loop)
    mix: Counter     # pipe -> instructions, excluding nested loops


def cuobjdump() -> str:
    found = shutil.which('cuobjdump')
    if found:
        return found
    path = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'cuobjdump'
    if path.exists():
        return str(path)
    raise RuntimeError('cuobjdump not found: it comes with the CUDA toolkit')


def disassemble(lib: Path) -> Dict[str, List[Instr]]:
    """-> {mangled kernel name: its SASS instructions in address order}."""
    return parse(subprocess.run([cuobjdump(), '-sass', str(lib)],
                                check=True, capture_output=True,
                                text=True).stdout)


def parse(text: str) -> Dict[str, List[Instr]]:
    """``cuobjdump -sass`` output -> {kernel name: instructions}."""
    out: Dict[str, List[Instr]] = {}
    current = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and current is not None:
            current.append(Instr(int(m.group(1), 16), m.group(3),
                                 ' '.join(m.group(0).split())))
    return out


def pipe(op: str) -> str:
    return PIPE_OF.get(op, 'other')


def regions(instrs: List[Instr]) -> List[Region]:
    """Straight-line code and each loop, found as a branch to an earlier
    address; each region's mix excludes the loops nested in it."""
    spans = []
    for ins in instrs:
        if ins.op in ('BRA', 'BRX', 'JMP'):
            m = _TARGET.search(ins.text.split(ins.op, 1)[1])
            if m and int(m.group(1), 16) < ins.addr:
                spans.append((int(m.group(1), 16), ins.addr))
    spans.sort(key=lambda s: (s[0], -s[1]))

    def depth(span):
        return 1 + sum(1 for o in spans
                       if o != span and o[0] <= span[0] and span[1] <= o[1])

    def innermost(addr):
        inside = [s for s in spans if s[0] <= addr <= s[1]]
        return min(inside, key=lambda s: s[1] - s[0]) if inside else None

    mixes = {None: Counter()}
    mixes.update({s: Counter() for s in spans})
    for ins in instrs:
        mixes[innermost(ins.addr)][pipe(ins.op)] += 1
    first, last = instrs[0].addr, instrs[-1].addr
    return ([Region(0, first, last, mixes[None])]
            + [Region(depth(s), s[0], s[1], mixes[s]) for s in spans])


# Operations that more than one pipe can issue, by class: a right shift
# by a constant is SHF on the ALU or IMAD.HI (a multiply-high by a power
# of two), a left shift SHF or IMAD.SHL; a bit set into a clear bit of a
# word (w | b << j, or 2 w + b) is LOP3 or LEA on the ALU or an IMAD
# (IMAD.X adds a carry).  Only the function operation counts
# (chip_smoke.FUNCTION_OPS) name them; SASS has each on its own pipe.
FLEXIBLE = {'shift': ('alu', 'imad'), 'bitset': ('alu', 'imad')}


def _clocks(mix: Mapping[str, float]) -> Dict[str, float]:
    clocks = {'issue': sum(mix.values()) / PIPE_RATES['issue'],
              'fma': (mix.get('fp32', 0) + mix.get('imad', 0))
              / PIPE_RATES['fp32']}
    clocks.update({p: mix.get(p, 0) / PIPE_RATES[p] for p in PIPE_RATES
                   if p != 'issue'})
    return clocks


def resource_clocks(mix: Mapping[str, float]) -> Dict[str, float]:
    """Clocks of one SM that ``mix`` (pipe -> thread-instructions) needs
    of each resource: the issue slots, each pipe, and the FMA pipe that
    fp32 and imad share.  The operations of the ``FLEXIBLE`` classes are
    split between their pipes (the classes of one pair of pipes
    together) so that the busiest resource is least busy; the issue
    slots count them all, wherever they go."""
    fixed = {p: n for p, n in mix.items() if p not in FLEXIBLE}
    pools: Dict[tuple, float] = {}
    for cls, pair in FLEXIBLE.items():
        pools[pair] = pools.get(pair, 0) + mix.get(cls, 0)
    for (a, b), flex in pools.items():
        if not flex:
            continue

        def at(x, base=dict(fixed)):
            m = dict(base)
            m[a] = m.get(a, 0) + flex - x
            m[b] = m.get(b, 0) + x
            return m

        # each resource is linear in x (the share on pipe b), so the
        # busiest is least at an end or where two resources cross; among
        # equals, take the split whose next busiest resource is least
        lo, hi = _clocks(at(0)), _clocks(at(flex))
        xs = {0.0, float(flex)}
        for r, s in itertools.combinations(lo, 2):
            slope = (hi[r] - lo[r]) - (hi[s] - lo[s])
            if slope:
                x = flex * (lo[s] - lo[r]) / slope
                if 0 < x < flex:
                    xs.add(x)
        fixed = at(min(xs, key=lambda x: sorted(_clocks(at(x)).values(),
                                                reverse=True)))
    return _clocks(fixed)


def bound_clocks(mix: Mapping[str, float]) -> float:
    """Least clocks of one SM for ``mix``: its busiest resource."""
    return max(resource_clocks(mix).values())


def path_mix(instrs: List[Instr], spans) -> Counter:
    """Pipe mix of the instructions in the inclusive address ``spans``."""
    mix = Counter()
    for ins in instrs:
        if any(lo <= ins.addr <= hi for lo, hi in spans):
            mix[pipe(ins.op)] += 1
    return mix


# griddepcontrol.wait (programmatic dependent launch) in SASS, and the
# instructions that read or write global memory
GRID_WAIT = 'ACQBULK'
GLOBAL_MEMORY = ('LDG', 'STG', 'LD', 'ST', 'ATOM', 'ATOMG', 'RED', 'LDGSTS')
# control flow: a guard (@P0 ...) or a predicate operand (BRA !P3, ...)
# makes a branch or an exit conditional
_GUARDED = re.compile(r'\*/ @|\s!?U?P[T0-9]+\s*,')
_ENDS = ('EXIT', 'RET', 'KILL')
_INDIRECT = ('BRX', 'JMX', 'JMP', 'CALLX')


def successors(instrs: List[Instr], k: int) -> List[int]:
    """Indices of the instructions that may run after ``instrs[k]``: the
    next one unless it is an unconditional branch or end, and a branch's
    or call's target (a call returns to the next one)."""
    ins = instrs[k]
    if ins.op in _INDIRECT:
        raise RuntimeError(f'indirect branch: {ins.text}')
    guarded = bool(_GUARDED.search(ins.text))
    nxt = [k + 1] if k + 1 < len(instrs) else []
    if ins.op in _ENDS:
        return nxt if guarded else []
    if ins.op not in ('BRA', 'CALL'):
        return nxt
    target = int(_TARGET.findall(ins.text)[-1], 16)
    at = [j for j, i in enumerate(instrs) if i.addr == target]
    if not at:
        raise RuntimeError(f'branch to no instruction: {ins.text}')
    return at + (nxt if guarded or ins.op == 'CALL' else [])


def memory_before_wait(instrs: List[Instr]) -> List[Instr]:
    """The global loads and stores that some path from the entry reaches
    without passing a griddepcontrol.wait, in address order (a walk of
    the control flow: branches, calls and conditional exits); raises if
    ``instrs`` has no wait."""
    if not any(i.op == GRID_WAIT for i in instrs):
        raise RuntimeError(f'no {GRID_WAIT} (griddepcontrol.wait)')
    seen, todo, early = {0}, [0], []
    while todo:
        k = todo.pop()
        if instrs[k].op == GRID_WAIT:
            continue
        if instrs[k].op in GLOBAL_MEMORY:
            early.append(instrs[k])
        for j in successors(instrs, k):
            if j not in seen:
                seen.add(j)
                todo.append(j)
    return sorted(early, key=lambda i: i.addr)


def fingerprint(instrs: List[Instr]) -> str:
    return hashlib.sha256('\n'.join(i.text for i in instrs).encode()
                          ).hexdigest()[:16]


# The path one unit of work takes through each kernel on the main path
# (K=20 clients, bits=3, vote counts on, shared gbar, every float
# division on its fast path), as inclusive SASS address spans.  They were
# read off the disassembly of the build whose fingerprint is given (nvcc
# 12.9, sm_90a): a changed source or compiler moves the addresses, and
# ``--paths`` then reports the mismatch so the spans can be read anew.
MAIN_PATHS = {
    'quantize_pack': ('940b912c666bf1e7', {
        # quantize_pack_kernel<3>: a thread of a warp with a live group
        # (step > 0, every division on its fast path, the slow-path calls
        # skipped) loads its GPW coordinates, quantizes them, votes each
        # plane and stages the words; the lanes that store a word run one
        # trip of the store loop (bits 3: 16 words per warp); warps past
        # the last group exit.  A coordinate and a plane have no span of
        # their own: their instructions are in the live thread's.
        'live_thread': ((0x0000, 0x0670), (0x06d0, 0x0700), (0x0860, 0x08f0),
                        (0x0940, 0x0a70), (0x0ad0, 0x0c00), (0x0c60, 0x0d90),
                        (0x0df0, 0x13e0)),
        'store_word': ((0x13f0, 0x1760),),
        'idle_thread': ((0x0000, 0x0080),),
        'coordinate': (),
        'plane': (),
    }),
    'spfl_accumulate': ('e063fbae61d1b1b1', {
        # one chunk (K <= 32); a thread holds two coordinates and copies
        # five words of one kind (sign or knob: 128 threads, 32 words per
        # client at bits 3), one trip of the rolled remainder and one of
        # the 4x unrolled copy loop.  Every thread: set-up, the copy
        # loops' entries and exits, the scalar copies (predicated), the
        # wait and barrier, the stores' tests; per live thread the
        # shared-gbar, bits = 3 dispatch and its stores; per client of a
        # live thread one trip of that loop (both coordinates).  A
        # coordinate and a client of one have no span of their own.
        'thread': ((0x0000, 0x08e0), (0x0c10, 0x0c30), (0x1800, 0x1f60),
                   (0x3a40, 0x3ab0), (0xf8e0, 0xfa30)),
        'sign_copier': ((0x08f0, 0x0920), (0x09e0, 0x0c00),
                        (0x0c40, 0x0c70), (0x0d30, 0x0f90),
                        (0x1060, 0x1260), (0x1330, 0x1530),
                        (0x1600, 0x17f0)),
        'knob_copier': ((0x08f0, 0x09d0), (0x0a60, 0x0c00),
                        (0x0c40, 0x0d20), (0x0db0, 0x1050),
                        (0x10e0, 0x1320), (0x13b0, 0x15f0),
                        (0x1680, 0x17f0)),
        'live_thread': ((0x3ac0, 0x3bf0), (0x9e70, 0x9f20), (0x9f30, 0x9f50),
                        (0xa2e0, 0xa2e0), (0xfa40, 0xfa60)),
        'client_pair': ((0x9f60, 0xa2d0),),
        'coordinate': (),
        'client': (),
    }),
    'corrupt_fold': ('6f16689711cf1d79', {
        # every thread: entry, bounds test, the warp and block reductions;
        # a thread with a word: the loop's preheader (with the two seed
        # words' loads); per word one trip (the 32-plane PRF, the xor, fold
        # and count); per block of a row of several: its first thread's
        # two atomics and the predicated fold store; per row: the count's
        # last block's store
        'thread': ((0x0000, 0x00f0), (0x1770, 0x1960)),
        'worker': ((0x0100, 0x0370),),
        'word': ((0x0380, 0x1760),),
        'block': ((0x1970, 0x1cb0),),
        'row': ((0x1cc0, 0x1cf0),),
    }),
    'fold_words': ('8a77a7a1f5dce961', {
        # every thread: set-up, the split cluster barrier, the warp and
        # block folds; per trip of eight loads the rolled remainder (one
        # trip per thread at the main widths); the other blocks' threads
        # exit, and their thread 0 stores into the leader; the leader's
        # other warps exit and its warp 0 waits once on the mbarrier (the
        # spin is not counted), folds the slices and stores.  A word has
        # no instruction of its own: its load and xor are in its trip.
        'thread': ((0x0000, 0x02f0), (0x0b00, 0x0d70)),
        'trip': ((0x0860, 0x0af0),),
        'follower_thread': ((0x0d80, 0x0d90),),
        'follower_store': ((0x0da0, 0x0e40),),
        'leader_thread': ((0x0e50, 0x0e60),),
        'leader_warp_thread': ((0x0e70, 0x0ed0), (0x0ee0, 0x1050)),
        'word': (),
    }),
    # the per-client kernel API: every float division on its fast path,
    # step > 0, mod_ok > 0
    'quantize': ('4d0895fad64d07d3', {
        # quantize_kernel<4> (16-byte input loads; the library holds one
        # function per load width, 4 and 2 floats): every thread:
        # set-up and the exit test; a thread with coordinates: the wait,
        # its loads (both kinds are predicated, so both issue), the two
        # scalar loads and the knob step's division on its fast path; then
        # a tail thread's quotient, knob, sign and two stores, or a vector
        # thread's CPT quotients (each division on its fast path), knobs,
        # signs and its 4- and 16-byte stores.  A coordinate has no span
        # of its own.
        'thread': ((0x0000, 0x00f0),),
        'live_thread': ((0x0100, 0x02e0), (0x0320, 0x03a0)),
        'tail_thread': ((0x03b0, 0x0470), (0x04b0, 0x05d0)),
        'vector_thread': ((0x05e0, 0x06b0), (0x0700, 0x07d0),
                          (0x0820, 0x0910), (0x0960, 0x0a30),
                          (0x0a80, 0x0e70)),
        'coordinate': (),
    }),
    'dequant': ('d969def6d87faceb', {
        # every thread: set-up and the exit test (threads past the end
        # exit there); a thread with coordinates (CPT by vector or one of
        # the tail's): the wait, its loads (both kinds' loads are
        # predicated, so both issue), the four scalar loads and the knob
        # step's division on its fast path; then a vector thread's CPT
        # outputs and 16-byte store, or a tail thread's one output and
        # store.  A coordinate has no span of its own.
        'thread': ((0x0000, 0x00f0),),
        'live_thread': ((0x0100, 0x0470), (0x04b0, 0x04b0)),
        'vector_thread': ((0x0560, 0x0720),),
        'tail_thread': ((0x04c0, 0x0550),),
        'coordinate': (),
    }),
    'roundtrip': ('44a21741e34ddb2c', {
        # roundtrip_kernel<4>, with quantize's thread kinds: a thread
        # with coordinates adds the gbar load and the mod_ok and weight
        # scalar loads; a tail or vector thread the decode (predicated on
        # mod_ok, so it issues at mod_ok 1 only), the weighted product and
        # a 4- or 16-byte store.
        'thread': ((0x0000, 0x00f0),),
        'live_thread': ((0x0100, 0x0390), (0x03e0, 0x0400)),
        'tail_thread': ((0x0410, 0x04d0), (0x0520, 0x06c0)),
        'vector_thread': ((0x06d0, 0x07a0), (0x07f0, 0x08c0),
                          (0x0910, 0x0a00), (0x0a50, 0x0b20),
                          (0x0b70, 0x1050)),
        'coordinate': (),
    }),
    'pack_bits': ('1d080b580ac4eafb', {
        # pack_bits_kernel<3>: a thread of a warp with a live group waits,
        # loads its GPW values, votes each plane and stages the words, and
        # exits unless it stores one; a lane that stores a word (bits 3:
        # 12 words per warp, one unrolled trip) adds the store; warps past
        # the last group exit.  A plane has no span of its own.
        'live_thread': ((0x0000, 0x05c0),),
        'store_word': ((0x05d0, 0x0650),),
        'idle_thread': ((0x0000, 0x0080),),
        'plane': (),
    }),
    'unpack_bits': ('ab49676818bf08ce', {
        # unpack_bits_kernel<3> (the library holds one function per bit
        # width 1..32): a thread with a value waits, loads its group's 3
        # plane words (warp broadcasts), builds its value and stores it;
        # threads past the end exit.  A plane has no span of its own.
        'coordinate': ((0x0000, 0x01d0),),
        'idle_thread': ((0x0000, 0x0060),),
        'plane': (),
    }),
    'unpack_dequant': ('b89c87e4cfe116c0', {
        # unpack_dequant_kernel<3> on the wrapper's aligned tensors: every
        # lane of a vector warp runs the set-up, the wait, its loads (the
        # warp's words, of which lanes 4..15 take knob words, its gbar
        # vector, predicated, and the four scalar loads), the staging and
        # the knob step's division on its fast path; a lane with a vector
        # of 4 adds the planes, the outputs and the 16-byte store; a
        # scalar thread of the tail loads its group's words, gbar and the
        # scalars and decodes one coordinate; threads past the end exit.
        # A coordinate and a plane have no span of their own.
        'warp_lane': ((0x0000, 0x00a0), (0x04f0, 0x0600), (0x0660, 0x08c0),
                      (0x0900, 0x0900)),
        'vector': ((0x0910, 0x0dd0),),
        'scalar_thread': ((0x0000, 0x03c0), (0x0400, 0x04e0)),
        'idle_thread': ((0x0000, 0x0100),),
        'coordinate': (),
        'plane': (),
    }),
    'alloc_solve': ('a7ae398911689dfa', {
        # alloc_solve_kernel (float64, blocks of 256 threads): one trip of
        # each loop by one client's thread, read from the loop structure
        # (sass.regions) and the branches of the build's SASS: the grid
        # loop's G' evaluation; a Newton step of a bracket's thread; a
        # golden step of one lane of the bisection's speculative round
        # (the bisection's copy of the inlined golden loop: its head, the
        # branch past the tolerance vote, the bracket update and the
        # two-lane path's surrogate evaluation and shuffle, both branches
        # of each term's sign test in the span, one of which runs; a
        # golden pair is two such steps, one a lane); a barrier step
        # without its backtracking loop (the ordered sums' add loops of
        # thread 0 and the votes across blocks inside); one backtracking
        # trip.  The float64 divisions' slow path, pow's and exp's
        # subroutines are CALLs outside the spans (a division on its fast
        # path is inline).  The other units have no span of their own.
        'grid_point': ((0x06ba0, 0x08510),),
        'newton_step': ((0x09660, 0x0c130),),
        'golden_step': ((0x362f0, 0x36320), (0x38c40, 0x38db0),
                        (0x3e3f0, 0x410d0)),
        'golden_pair': (),
        'barrier_step': ((0x5dbd0, 0x63930), (0x662c0, 0x67770)),
        'backtrack': ((0x63940, 0x662b0),),
        'bracket': (),
        'alpha_client': (),
        'golden_call': (),
        'sca_round': (),
        'objective': (),
    }),
    'alloc_solve_f32': ('f2de47abcf7775ba', {
        # alloc_solve_kernel<float>, the same units as alloc_solve's (its
        # float64 twin's build has alloc_solve's fingerprint: the template
        # left its SASS as it was).  The two functions have the same loop
        # structure (sass.regions: 191 loops at the same depths), so each
        # span is the f32 loop of the same place: the grid loop and the
        # Newton loop whole; a golden step's head (the tolerance-exit
        # test), the bracket update (predicated here, not branched) up to
        # the two-lane branch, and the two-lane path to the loop's end,
        # with the surrogate evaluations and the shuffle; the barrier
        # step around the backtracking loop, and that loop.  The f32
        # divisions' slow path and powf's and expf's subroutines are CALLs
        # outside the spans.
        'grid_point': ((0x06140, 0x06f90),),
        'newton_step': ((0x08020, 0x094a0),),
        'golden_step': ((0x269c0, 0x269f0), (0x293e0, 0x29500),
                        (0x2cb70, 0x2e8b0)),
        'golden_pair': (),
        'barrier_step': ((0x43cd0, 0x48670), (0x4b070, 0x4c510)),
        'backtrack': ((0x48680, 0x4b060),),
        'bracket': (),
        'alpha_client': (),
        'golden_call': (),
        'sca_round': (),
        'objective': (),
    }),
}


def main_path(name: str, funcs: Mapping[str, List[Instr]]) -> List[Instr]:
    """The function of kernel ``name``'s library (``funcs``, as from
    :func:`disassemble`) whose SASS the ``MAIN_PATHS`` spans were read
    from, found by fingerprint; raises if there is none, so the spans
    must be read anew."""
    want = MAIN_PATHS[name][0]
    for instrs in funcs.values():
        if fingerprint(instrs) == want:
            return instrs
    got = sorted(fingerprint(i) for i in funcs.values())
    raise RuntimeError(f'{name}: no SASS fingerprint {got} is {want}: read '
                       'the main-path spans anew from --dump')


def main_path_mixes(name: str, instrs: List[Instr]) -> Dict[str, Counter]:
    """{unit of work: its pipe mix} of kernel ``name`` on the main path;
    raises if ``instrs`` is not the disassembly the spans were read from."""
    want, units = MAIN_PATHS[name]
    got = fingerprint(instrs)
    if got != want:
        raise RuntimeError(f'{name}: SASS fingerprint {got} != {want}: read '
                           'the main-path spans anew from --dump')
    return {unit: path_mix(instrs, spans) for unit, spans in units.items()}


def main() -> None:
    from repro_torch.kernels import build
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--dump', type=Path, default=None,
                        help='write each disassembly to DIR/<kernel>.sass')
    parser.add_argument('--paths', action='store_true',
                        help='also print the main-path mix of each unit '
                             'of work (MAIN_PATHS)')
    args = parser.parse_args()
    for name, lib in build.build().items():
        funcs = disassemble(lib)
        if args.dump is not None:
            args.dump.mkdir(parents=True, exist_ok=True)
            (args.dump / f'{name}.sass').write_text('\n'.join(
                f'{fn}\n' + '\n'.join(i.text for i in instrs)
                for fn, instrs in funcs.items()) + '\n')
        for fn, instrs in funcs.items():
            print(f'{name} ({fn}): {len(instrs)} instructions, '
                  f'fingerprint {fingerprint(instrs)}')
            for r in regions(instrs):
                kind = 'straight-line' if r.depth == 0 else f'loop depth {r.depth}'
                print(f'  {kind} [{r.start:#06x}, {r.end:#06x}]: '
                      + ', '.join(f'{p} {c}' for p, c in sorted(r.mix.items())))
        if args.paths:
            for unit, mix in main_path_mixes(
                    name, main_path(name, funcs)).items():
                print(f'  main path per {unit}: {dict(sorted(mix.items()))}')


if __name__ == '__main__':
    main()
