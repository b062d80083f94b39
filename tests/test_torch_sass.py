"""The SASS instruction-mix reader (``repro_torch.kernels.sass``), on a
listing in ``cuobjdump -sass``'s format: the disassembler itself needs the
CUDA toolkit.  Also the kernel table of ``kernels.build`` and the
function operation counts that ``chip_smoke.py`` bounds each kernel by."""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.kernels import build, sass

ROOT = pathlib.Path(__file__).resolve().parents[1]

LISTING = """
\tcode for sm_90a
\t\tFunction : _Z6kernelPj
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
                                                                     /* 0x000fe40000000800 */
        /*0010*/                   IMAD.MOV.U32 R0, RZ, RZ, 0x1 ;    /* 0x0000000000007919 */
        /*0020*/                   LOP3.LUT R2, R0, 0xff, RZ, 0xc0, !PT ;
        /*0030*/                   SHF.R.U32.HI R3, RZ, 0x10, R2 ;
        /*0040*/              @!P0 BRA 0x20 ;
        /*0050*/                   I2F.U32 R4, R3 ;
        /*0060*/                   FFMA R5, R4, R4, R4 ;
        /*0070*/               @P1 BRA 0x10 ;
        /*0080*/                   SHFL.BFLY PT, R6, R5, 0x10, 0x1f ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0;
\t\tFunction : _Z5otherv
        /*0000*/                   EXIT ;
"""


def test_parse_splits_kernels_and_reads_base_opcodes():
    funcs = sass.parse(LISTING)
    assert sorted(funcs) == ['_Z5otherv', '_Z6kernelPj']
    ops = [i.op for i in funcs['_Z6kernelPj']]
    assert ops == ['LDC', 'IMAD', 'LOP3', 'SHF', 'BRA', 'I2F', 'FFMA', 'BRA',
                   'SHFL', 'EXIT', 'BRA']
    assert [i.addr for i in funcs['_Z6kernelPj']] == list(range(0, 0xb0, 0x10))
    assert funcs['_Z6kernelPj'][4].text == '/*0040*/ @!P0 BRA 0x20 ;'


def test_regions_nest_loops_and_exclude_inner_bodies():
    got = sass.regions(sass.parse(LISTING)['_Z6kernelPj'])
    # the trailing self-branch after EXIT is no loop
    assert [(r.depth, r.start, r.end) for r in got] == [
        (0, 0x00, 0xa0), (1, 0x10, 0x70), (2, 0x20, 0x40)]
    assert got[0].mix == {'other': 3, 'shfl': 1}
    assert got[1].mix == {'imad': 1, 'xu': 1, 'fp32': 1, 'other': 1}
    assert got[2].mix == {'alu': 2, 'other': 1}
    assert sum(sum(r.mix.values()) for r in got) == 11


@pytest.mark.parametrize('mix,clocks', [
    ({'alu': 64}, 1.0),                        # the INT32 pipe alone
    ({'alu': 64, 'imad': 64}, 1.0),            # two pipes side by side
    ({'alu': 64, 'imad': 64, 'other': 128}, 2.0),   # issue-bound
    ({'fp32': 128, 'imad': 64}, 1.5),          # the shared FMA pipe
    ({'xu': 16, 'fp32': 16}, 1.0),             # conversions
    ({'shfl': 64}, 2.0),
    ({'other': 256}, 2.0),
])
def test_bound_clocks_takes_the_busiest_resource(mix, clocks):
    assert sass.bound_clocks(mix) == pytest.approx(clocks)


@pytest.mark.parametrize('mix,clocks,limit', [
    # shifts split evenly: ALU and IMAD each 64, at the issue limit
    ({'alu': 64, 'shift': 64}, 1.0, 'issue'),
    # all shifts to IMAD and the ALU still the busiest
    ({'alu': 128, 'shift': 64}, 2.0, 'alu'),
    # all shifts to the ALU when IMAD is the busier pipe
    ({'imad': 128, 'shift': 64}, 2.0, 'imad'),
    # never under the issue limit, however the shifts are split
    ({'shift': 256}, 2.0, 'issue'),
    ({'fp32': 256, 'shift': 64}, 2.5, 'issue'),
    # the shifts split where the two pipes meet, under the issue limit
    ({'alu': 96, 'imad': 32, 'shift': 64, 'other': 32}, 1.75, 'issue'),
    ({'alu': 112, 'imad': 16, 'shift': 32}, 1.75, 'alu'),
    # corrupt_fold per word with its bit sets held on the ALU: alu 172,
    # shift 68, imad 67
    ({'alu': 172, 'shift': 68, 'imad': 67, 'xu': 1}, 172 / 64, 'alu'),
    # bit sets go where shifts go, placed with them as one pool
    ({'alu': 64, 'bitset': 64}, 1.0, 'issue'),
    ({'alu': 96, 'shift': 16, 'bitset': 16}, 1.5, 'alu'),
    ({'imad': 96, 'shift': 32, 'bitset': 32, 'alu': 32}, 1.5, 'issue'),
    # corrupt_fold per word: with its 32 bit sets placed too it is held
    # by the issue limit, 308 / 128, not by its ALU share (172 / 64 with
    # the bit sets fixed there)
    ({'alu': 140, 'shift': 68, 'bitset': 32, 'imad': 67, 'xu': 1},
     308 / 128, 'issue'),
])
def test_shifts_go_where_the_busiest_pipe_is_least_loaded(mix, clocks,
                                                          limit):
    got = sass.resource_clocks(mix)
    assert max(got.values()) == pytest.approx(clocks)
    assert max(got, key=got.get) == limit
    # among the splits that reach it, the one that leaves both pipes
    # least loaded
    assert max(got['alu'], got['imad']) <= clocks
    # no split of the shifts and bit sets between the ALU and IMAD does
    # better
    flex = sum(mix.get(c, 0) for c in sass.FLEXIBLE)
    fixed = {p: n for p, n in mix.items() if p not in sass.FLEXIBLE}
    for x in range(0, flex + 1, 4):
        split = dict(fixed, alu=fixed.get('alu', 0) + flex - x,
                     imad=fixed.get('imad', 0) + x)
        assert sass.bound_clocks(split) >= clocks - 1e-9


def test_flexible_classes_share_one_pair_of_pipes():
    """Every class of sass.FLEXIBLE is placed between the ALU and IMAD,
    and a mix's bound depends only on how many such operations it has,
    not on their class."""
    assert set(sass.FLEXIBLE.values()) == {('alu', 'imad')}
    for n in (0, 24, 100):
        a = sass.resource_clocks({'alu': 140, 'imad': 67, 'shift': n,
                                  'bitset': 100 - n})
        b = sass.resource_clocks({'alu': 140, 'imad': 67, 'shift': 100})
        assert a == pytest.approx(b)


def test_placement_leaves_fixed_mixes_alone():
    mix = {'alu': 331, 'imad': 83, 'other': 31, 'shfl': 10, 'xu': 1}
    assert sass.resource_clocks(mix) == sass._clocks(mix)


def test_resource_clocks_names_the_limit():
    clocks = sass.resource_clocks({'alu': 331, 'imad': 83, 'other': 31,
                                   'shfl': 10, 'xu': 1})
    assert max(clocks, key=clocks.get) == 'alu'
    assert clocks['issue'] == pytest.approx(456 / 128)
    assert clocks['fma'] == pytest.approx(83 / 128)


def test_every_pipe_has_a_rate_and_unknown_opcodes_only_issue():
    assert set(sass.PIPE_OF.values()) <= set(sass.PIPE_RATES)
    assert sass.pipe('IMAD') == 'imad' and sass.pipe('LOP3') == 'alu'
    assert sass.pipe('STG') == 'other' and sass.pipe('VOTE') == 'other'


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('name', build.KERNELS)
def test_every_kernel_has_a_source_main_path_and_unit_mix(name):
    """Each kernel of ``build.TABLE`` has its own source, a path, the
    Pallas body it replaces, SASS spans on its main path with the
    fingerprint of the build they were read from, and the operations of
    its function in ``chip_smoke.FUNCTION_OPS`` per units of those spans."""
    cs = _chip_smoke()
    kern = build.TABLE[name]
    assert build.source(name).is_file()
    assert (ROOT / build.repo_source(name)) == build.source(name)
    assert kern.path in ('round', 'api', 'alloc')
    path, line = kern.replaces.split(':')
    text = (ROOT / path).read_text().splitlines()[int(line) - 1]
    if kern.path == 'alloc':
        # the JAX engine's solver: one XLA program, no Pallas body
        assert text.startswith('def solve_traceable')
    else:
        assert 'kernel' in text
    fingerprint, units = sass.MAIN_PATHS[name]
    assert len(fingerprint) == 16 and int(fingerprint, 16) >= 0
    ops = cs.FUNCTION_OPS[name]
    assert ops and set(ops) <= set(units)
    assert all(set(mix) <= set(sass.PIPE_RATES) | set(sass.FLEXIBLE)
               for mix in ops.values())


def test_the_round_and_the_api_split_the_kernels():
    cs = _chip_smoke()
    assert cs.kernels_on('round') == ['quantize_pack', 'spfl_accumulate',
                                      'corrupt_fold', 'fold_words']
    assert len(cs.kernels_on('api')) == 6
    assert set(cs.FUNCTION_OPS) == set(build.KERNELS)


def test_launch_mix_sums_units_and_skips_units_without_work():
    cs = _chip_smoke()
    per_unit = {'coordinate': {'fp32': 4, 'alu': 1}, 'plane': {'alu': 3}}
    assert cs.launch_mix(per_unit, {'coordinate': 10, 'plane': 30,
                                    'lane': 32}) == {'fp32': 40, 'alu': 100}


@pytest.fixture
def other_sources(tmp_path, monkeypatch):
    """``tmp_path`` as the ``csrc/`` that ``build`` builds from."""
    monkeypatch.setattr(build, 'CSRC', tmp_path)
    return tmp_path


def test_library_path_hashes_the_included_headers(other_sources):
    """An edited ``csrc/`` header renames (so rebuilds) the library of
    every source that includes it, and of no other."""
    (other_sources / 'shared.cuh').write_text('#pragma once\n')
    (other_sources / 'user.cu').write_text('#include <cstdint>\n'
                                           '#include "shared.cuh"\n')
    (other_sources / 'alone.cu').write_text('#include <cstdint>\n')
    before = build.library_path('user'), build.library_path('alone')
    (other_sources / 'shared.cuh').write_text('#pragma once\n// edited\n')
    after = build.library_path('user'), build.library_path('alone')
    assert after[0] != before[0] and after[1] == before[1]
    assert after[0].name.startswith('user-')


@pytest.mark.parametrize('name,keys', [
    ('spfl_accumulate', {'TILE', 'CHUNK', 'CPT'}),
    ('fold_words', {'CLUSTER', 'THREADS', 'UNROLL'}),
    ('quantize_pack', {'THREADS', 'GPW'}),
    ('corrupt_fold', {'THREADS'}),
    ('pack_bits', {'THREADS', 'GPW'}),
    ('dequant', {'THREADS', 'CPT'}),
    ('quantize', {'THREADS', 'CPT'}),
    ('roundtrip', {'THREADS', 'CPT'}),
    ('unpack_bits', {'THREADS'}),
    ('unpack_dequant', {'THREADS'})])
def test_constants_read_the_launch_shape_from_the_source(name, keys):
    """The launch constants that chip_smoke.py's unit counts and edge
    sweep use are the literals of the kernel's source."""
    shape = build.constants(name)
    assert keys <= set(shape) and all(shape[k] > 0 for k in keys)
    text = build.source(name).read_text()
    for key in keys:
        assert f'constexpr int {key} = {shape[key]};' in text


def test_constants_skip_expressions(tmp_path, monkeypatch):
    monkeypatch.setattr(build, 'CSRC', tmp_path)
    (tmp_path / 'k.cu').write_text('constexpr int A = 4;  // four\n'
                                   'constexpr int B = A / 2;\n'
                                   '  constexpr int C = 3;\n')
    assert build.constants('k') == {'A': 4}


def _fold_trips_by_walking(w):
    """Trips of fold_words.cu's load loop over one row of w words, walked
    as the kernel walks them: block r of the cluster folds words
    [r * per, min((r + 1) * per, w)), thread t from lo + t in steps of
    UNROLL * THREADS."""
    shape = build.constants('fold_words')
    per = -(-w // shape['CLUSTER'])
    trips = 0
    for rank in range(shape['CLUSTER']):
        lo = min(w, rank * per)
        hi = min(w, lo + per)
        for t in range(shape['THREADS']):
            trips += len(range(lo + t, hi,
                               shape['UNROLL'] * shape['THREADS']))
    return trips


@pytest.mark.parametrize('w', [1, 7, 1943, 2047, 2049, 5822, 40000])
def test_fold_words_units_count_the_kernels_loop_trips(w):
    cs = _chip_smoke()
    units = cs.fold_words_units(3, w)
    assert units['trip'] == 3 * _fold_trips_by_walking(w)
    assert units['word'] == 3 * w
    shape = build.constants('fold_words')
    assert units['thread'] == 3 * shape['CLUSTER'] * shape['THREADS']


@pytest.mark.parametrize('k,n,bits', [(20, 62006, 3), (1, 1, 16),
                                      (33, 257, 1)])
def test_spfl_accumulate_units_cover_the_tiles(k, n, bits):
    cs = _chip_smoke()
    units = cs.spfl_accumulate_units(k, n, bits)
    shape = build.constants('spfl_accumulate')
    tile, cpt = shape['TILE'], shape['CPT']
    blocks = -(-n // tile)
    assert units['thread'] * cpt == blocks * tile >= n
    assert units['sign_copier'] + units['knob_copier'] == units['thread']
    # the live threads hold every coordinate, CPT at a time; only the
    # last group's may hold fewer
    assert n <= units['live_thread'] * cpt < n + 32
    assert units['client_pair'] == units['live_thread'] * k
    assert units['client'] == n * k and units['coordinate'] == n


def test_kernel_ab_needs_a_card():
    """The same-call A/B script times kernels on a CUDA card only: with
    every card hidden it says so, fails and prints no timing, though both
    versions' sources (here this checkout's, twice) are there."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run([sys.executable, str(ROOT / 'kernel_ab.py'),
                          str(ROOT)], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0
    assert 'no CUDA card' in out.stderr
    assert 'ms' not in out.stdout


def test_use_sources_moves_the_build_and_not_the_repo_paths(tmp_path):
    """A kernel_ab.py turn on another tree uses that tree's sources: it
    imports the tree's package, whose kernels are built and hashed from
    the tree's ``csrc/`` into the tree's own build directory, while the
    checks and timing (chip_smoke) and the repository paths the results
    name stay this checkout's."""
    import shutil
    tree = tmp_path / 'prev'
    shutil.copytree(ROOT / 'src' / 'repro_torch', tree / 'src' / 'repro_torch',
                    ignore=shutil.ignore_patterns('__pycache__'))
    edited = tree / 'src' / 'repro_torch' / 'kernels' / 'csrc' / 'fold_words.cu'
    edited.write_text(edited.read_text() + '// an earlier version\n')
    probe = (
        'import json, sys\n'
        'from pathlib import Path\n'
        f'sys.path.insert(0, {str(ROOT)!r})\n'
        'import kernel_ab\n'
        f'cs, build = kernel_ab._import_tree(Path({str(tree)!r}))\n'
        'import repro_torch\n'
        'print(json.dumps(dict(package=repro_torch.__file__,\n'
        '    chip_smoke=cs.__file__, csrc=str(build.CSRC),\n'
        '    build_dir=str(build.BUILD_DIR),\n'
        "    lib=str(build.library_path('fold_words')),\n"
        "    repo_source=build.repo_source('fold_words'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / 'src'))
    out = subprocess.run([sys.executable, '-c', probe], capture_output=True,
                         text=True, timeout=120, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    inside = tree.resolve()
    for key in ('package', 'csrc', 'build_dir', 'lib'):
        assert pathlib.Path(got[key]).resolve().is_relative_to(inside), key
    assert pathlib.Path(got['chip_smoke']).resolve() == ROOT / 'chip_smoke.py'
    assert got['repo_source'] == 'src/repro_torch/kernels/csrc/fold_words.cu'
    # the edited source names another library than this checkout's
    assert pathlib.Path(got['lib']).name != \
        build.library_path('fold_words').name


@pytest.mark.parametrize('path', ['round', 'api'])
def test_kernel_ab_calls_each_round_kernels_wrapper(path):
    """The calls kernel_ab.py times, here through the plain versions on
    the CPU.  'round': each of the four round kernels' wrappers at the
    main shapes, on the bulk inputs that its cold timing copies.  'api':
    each kernel API wrapper at phase 6's shapes, with the second calls of
    pack_bits (bits 1) and dequant (mod_ok 0), the dependent chains,
    whose one input takes the shape of their output, the PDL kernels
    behind the call before them in phase 6, and one client's phase 6
    calls."""
    sys.path.insert(0, str(ROOT))
    try:
        import kernel_ab
    finally:
        sys.path.remove(str(ROOT))
    cs = _chip_smoke()
    calls = kernel_ab.wrapper_calls(cs, device='cpu', path=path)
    shapes = {name: [tuple(t.shape) for t in inputs]
              for name, (_, inputs) in calls.items()}
    if path == 'api':
        _check_api_calls(kernel_ab, cs, calls, shapes)
        return
    assert list(calls) == ['quantize_pack', 'spfl_accumulate',
                           'corrupt_fold', 'fold_words']
    assert shapes['quantize_pack'] == [(20, 62006)] * 2 + [(20,)] * 2
    assert shapes['spfl_accumulate'] == [(20, 1938), (20, 5814), (62006,)]
    assert shapes['corrupt_fold'] == [(20, 5822), (20,)]
    assert shapes['fold_words'] == [(20, 5822)]
    sw, qw = calls['quantize_pack'][0](*calls['quantize_pack'][1])
    assert (sw.shape, qw.shape) == ((20, 1938), (20, 5814))
    acc, votes = calls['spfl_accumulate'][0](*calls['spfl_accumulate'][1])
    assert acc.shape == votes.shape == (62006,)
    rx, fold, flips = calls['corrupt_fold'][0](*calls['corrupt_fold'][1])
    assert rx.shape == (20, 5822) and int(flips.sum()) > 0
    assert calls['fold_words'][0](*calls['fold_words'][1]).shape == (20,)


def _check_api_calls(kernel_ab, cs, calls, shapes):
    import torch
    assert list(calls) == [
        'quantize', 'quantize:odd_row', 'dequant', 'dequant:mod_ok0',
        'dequant:chain', 'roundtrip', 'roundtrip:mod_ok0',
        'roundtrip:odd_row', 'roundtrip:chain', 'pack_bits',
        'pack_bits:bits1', 'pack_bits:chain', 'unpack_bits',
        'unpack_dequant', 'unpack_bits:odd_row', 'unpack_bits:chain',
        'unpack_dequant:mod_ok0', 'unpack_dequant:odd_row',
        'unpack_dequant:chain', 'pack_bits:after_quantize',
        'pack_bits:after_sign_to_bits', 'dequant:after_roundtrip',
        'quantize:after_unpack_dequant', 'roundtrip:after_unpack_bits',
        'unpack_bits:after_pack_bits', 'unpack_dequant:after_dequant',
        'client:queued', 'client:synced']
    assert sorted({kernel_ab.kernel_of(c) for c in calls} - {'client'}) == \
        sorted(cs.kernels_on('api'))
    n = 62006
    assert shapes['quantize'] == [(n,)] * 2
    assert shapes['quantize:odd_row'] == [(2, n)] * 2
    assert shapes['dequant'] == shapes['dequant:mod_ok0'] == [(n,)] * 3
    assert shapes['roundtrip'] == shapes['roundtrip:mod_ok0'] == [(n,)] * 3
    assert shapes['roundtrip:odd_row'] == [(2, n)] * 2 + [(n,)]
    assert shapes['pack_bits'] == shapes['pack_bits:bits1'] == [(n,)]
    assert shapes['unpack_bits'] == [(1938 * 3,)]
    assert shapes['unpack_dequant'] == shapes['unpack_dequant:mod_ok0'] \
        == [(1938,), (1938 * 3,), (n,)]
    assert shapes['unpack_bits:odd_row'] == [(2, 1938 * 3)]
    assert shapes['unpack_dequant:odd_row'] == [(2, 1938), (2, 1938 * 3),
                                                (n,)]
    assert shapes['unpack_bits:chain'] == [(1938 * 32,)]
    assert shapes['unpack_dequant:chain'] == [(n,)]
    out = {c: fn(*inputs) for c, (fn, inputs) in calls.items()}
    assert out['pack_bits'].shape == (1938 * 3,)
    assert out['pack_bits:bits1'].shape == (1938,)
    assert torch.equal(out['unpack_bits'], calls['pack_bits'][1][0])
    assert not torch.equal(out['dequant'], out['dequant:mod_ok0'])
    # a chain's output is its next input; two 32 x 32 bit transposes
    # give back the values
    for chain in ('dequant:chain', 'pack_bits:chain', 'roundtrip:chain',
                  'unpack_bits:chain', 'unpack_dequant:chain'):
        fn, (x,) = calls[chain]
        assert out[chain].shape == x.shape and out[chain].dtype == x.dtype
    fn, (x,) = calls['pack_bits:chain']
    assert x.shape[0] % 32 == 0 and torch.equal(fn(fn(x)), x)
    # a call behind the one before it in phase 6 gives the lone call's
    # output; one client's calls hold phase 6's identities
    assert torch.equal(out['pack_bits:after_quantize'], out['pack_bits'])
    assert torch.equal(out['pack_bits:after_sign_to_bits'],
                       out['pack_bits:bits1'])
    for got, want in zip(out['dequant:after_roundtrip'],
                         (out['roundtrip'], out['dequant'])):
        assert torch.equal(got, want)
    (held, contrib), (unread, queued) = out['client:synced'], \
        out['client:queued']
    assert all(held.values()) and set(unread.values()) == {None}
    assert contrib.shape == (n,) and torch.equal(contrib, queued)


@pytest.mark.parametrize('call', ['roundtrip:mod_ok0', 'roundtrip:chain',
                                  'quantize:after_unpack_dequant',
                                  'roundtrip:after_unpack_bits',
                                  'quantize:odd_row', 'roundtrip:odd_row'])
def test_kernel_ab_times_the_quantize_and_roundtrip_calls(call):
    """kernel_ab.py's calls of the redesigned quantize and roundtrip, on
    the CPU: the roundtrip at mod_ok 0 is dequant at mod_ok 0 of the
    quantized client (phase 6 identity (d)); its chain, at weight 1,
    maps gbar to sign(g) * gbar, so a second step keeps each |value|;
    a call behind the one phase 6 makes before it gives both lone
    calls' outputs; a call on row 1 of (2, n) inputs (8 mod 16 apart)
    gives the lone call's output."""
    import torch
    sys.path.insert(0, str(ROOT))
    try:
        import kernel_ab
    finally:
        sys.path.remove(str(ROOT))
    calls = kernel_ab.api_calls(_chip_smoke(), device='cpu')

    def run(name):
        fn, inputs = calls[name]
        return fn(*inputs)

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return len(a) == len(b) and all(map(same, a, b))

    got = run(call)
    if call == 'roundtrip:mod_ok0':
        assert same(got, run('dequant:mod_ok0'))
        assert not same(got, run('roundtrip'))
    elif call == 'roundtrip:chain':
        fn, (gbar,) = calls[call]
        assert got.shape == gbar.shape and got.dtype == gbar.dtype
        assert same(fn(got).abs(), got.abs())
        assert same(got.abs(), gbar * (got != 0))
    elif call.endswith(':odd_row'):
        fn, inputs = calls[call]
        assert inputs[0][1].storage_offset() * 4 % 16 == 8
        assert same(got, run(call.split(':')[0]))
    else:
        before = {'quantize:after_unpack_dequant': 'unpack_dequant',
                  'roundtrip:after_unpack_bits': 'unpack_bits'}[call]
        assert same(got, (run(before), run(call.split(':')[0])))


@pytest.mark.parametrize('call', ['unpack_bits:odd_row', 'unpack_bits:chain',
                                  'unpack_dequant:mod_ok0',
                                  'unpack_dequant:odd_row',
                                  'unpack_dequant:chain',
                                  'unpack_bits:after_pack_bits',
                                  'unpack_dequant:after_dequant'])
def test_kernel_ab_times_the_unpack_calls(call):
    """kernel_ab.py's calls of the redesigned unpack_bits and
    unpack_dequant, on the CPU: a call on row 1 of (2, words) tensors
    (8 mod 16 apart) gives the lone call's output; the unpack_bits chain
    is a 32 x 32 bit transpose a group, which pack_bits at 32 bits
    undoes; the unpack_dequant chain (mod_ok 0, weight 1) maps gbar to
    +-gbar; unpack_dequant at mod_ok 0 is (w * s) * gbar, which equals
    dequant at mod_ok 0 of the client's signs (the wire sends sign 0 as
    +1); a call behind the one phase 6 makes before it gives both lone
    calls' outputs."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.wire import format as fmt
    sys.path.insert(0, str(ROOT))
    try:
        import kernel_ab
    finally:
        sys.path.remove(str(ROOT))
    calls = kernel_ab.api_calls(_chip_smoke(), device='cpu')

    def run(name):
        fn, inputs = calls[name]
        return fn(*inputs)

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return len(a) == len(b) and all(map(same, a, b))

    got = run(call)
    kernel = call.split(':')[0]
    if call.endswith(':odd_row'):
        fn, inputs = calls[call]
        assert all(t[1].storage_offset() * 4 % 16 == 8 for t in inputs
                   if t.dim() == 2)
        assert same(got, run(kernel))
    elif call == 'unpack_bits:chain':
        fn, (words,) = calls[call]
        assert got.shape == words.shape and not same(got, words)
        assert same(ops.pack_bits_flat(got, 32), words)
    elif call == 'unpack_dequant:chain':
        fn, (gbar,) = calls[call]
        assert got.shape == gbar.shape and got.dtype == gbar.dtype
        assert same(got.abs(), gbar) and same(fn(got).abs(), gbar)
    elif call == 'unpack_dequant:mod_ok0':
        assert not same(got, run('unpack_dequant'))
        # the same client through dequant at mod_ok 0, its signs as sent
        sign, qidx, gbar = calls['dequant:mod_ok0'][1]
        sent = fmt.bits_to_sign(fmt.sign_to_bits(sign))
        assert same(got, calls['dequant:mod_ok0'][0](sent, qidx, gbar))
    else:
        before = {'unpack_bits:after_pack_bits': 'pack_bits:bits1',
                  'unpack_dequant:after_dequant': 'dequant'}[call]
        assert same(got, (run(before), run(kernel)))


@pytest.mark.parametrize('n,bits', [(62006, 3), (62006, 32), (1, 1), (3, 5),
                                    (4, 3), (127, 16), (128, 3), (129, 3),
                                    (4096, 3), (4099, 8)])
@pytest.mark.parametrize('name', ['unpack_bits', 'unpack_dequant'])
def test_unpack_units_walk_the_grid(name, n, bits):
    """The unpack kernels' units against a walk of their grid on an
    aligned output.  unpack_bits: one thread a value, in whole blocks.
    unpack_dequant: vectors of 4 coordinates in warps of 32, whole warps
    first, then one scalar thread per coordinate of the
    ragged tail, in whole blocks; every coordinate once."""
    cs = _chip_smoke()
    shape = build.constants(name)
    units = cs.unpack_units(name, n, bits)
    assert units['coordinate'] == n and units['plane'] == n * bits
    assert set(cs.FUNCTION_OPS[name]) <= set(units)
    assert 0 <= units['idle_thread'] < shape['THREADS']
    if name == 'unpack_bits':
        assert (n + units['idle_thread']) % shape['THREADS'] == 0
        return
    covered = []
    for warp in range(units['warp_lane'] // 32):
        for u in range(32 * warp, 32 * (warp + 1)):
            if u < units['vector']:
                covered += range(4 * u, 4 * u + 4)
    covered += range(4 * units['vector'], n)
    assert covered == list(range(n))
    assert units['scalar_thread'] == n - 4 * units['vector'] < 4
    assert units['warp_lane'] == 32 * -(-units['vector'] // 32)
    total = units['warp_lane'] + units['scalar_thread'] + \
        units['idle_thread']
    assert total % shape['THREADS'] == 0


def test_memory_before_wait_reads_the_sass_up_to_the_grid_wait():
    """Global loads and stores that a path from the entry reaches before
    an ACQBULK (griddepcontrol.wait) are reported, also past the wait
    by a forward branch; constant-bank and shared-memory accesses are
    not; a kernel without the wait raises."""
    listing = LISTING.replace(
        '        /*0010*/                   IMAD.MOV.U32 R0, RZ, RZ, 0x1 ;',
        '        /*0008*/                   LDG.E.CONSTANT R7, desc[R2.64] ;\n'
        '        /*000c*/                   LDS R8, [R9] ;\n'
        '        /*0010*/                   ACQBULK ;\n'
        '        /*0018*/                   STG.E desc[UR4][R2.64], R7 ;')
    instrs = sass.parse(listing)['_Z6kernelPj']
    early = sass.memory_before_wait(instrs)
    assert [i.op for i in early] == ['LDG']
    assert sass.memory_before_wait([i for i in instrs
                                    if i.op not in ('LDG',)]) == []
    with pytest.raises(RuntimeError, match='griddepcontrol.wait'):
        sass.memory_before_wait(sass.parse(LISTING)['_Z6kernelPj'])
    # a guarded branch over the wait reaches the store behind it, a
    # guarded exit does not end the path, an unguarded one does
    jump = LISTING.replace(
        '        /*0010*/                   IMAD.MOV.U32 R0, RZ, RZ, 0x1 ;',
        '        /*0004*/               @P2 EXIT ;\n'
        '        /*0008*/               @P2 BRA 0x18 ;\n'
        '        /*0010*/                   ACQBULK ;\n'
        '        /*0018*/                   STG.E desc[UR4][R2.64], R7 ;')
    instrs = sass.parse(jump)['_Z6kernelPj']
    assert [i.addr for i in sass.memory_before_wait(instrs)] == [0x18]
    assert sass.memory_before_wait([i._replace(op='EXIT', text='EXIT ;')
                                    if i.addr == 0x4 else i
                                    for i in instrs]) == []


@pytest.mark.parametrize('n,bits', [(62006, 3), (62006, 1), (1, 32),
                                    (129, 16), (2048, 3), (2049, 8)])
def test_pack_bits_units_walk_the_grid(n, bits):
    """pack_bits' units against a walk of its grid: block b, warp j of it
    owns groups from (b * THREADS / 32 + j) * GPW on, a warp whose first
    group is past the last exits, and a live warp's lanes store its
    groups' words, one a lane and trip."""
    cs = _chip_smoke()
    shape = build.constants('pack_bits')
    warps, gpw = shape['THREADS'] // 32, shape['GPW']
    groups = -(-n // 32)
    blocks = -(-groups // (warps * gpw))
    starts = [(b * warps + j) * gpw for b in range(blocks)
              for j in range(warps)]
    live = [g for g in starts if g < groups]
    units = cs.pack_bits_units(n, bits)
    assert units['live_thread'] == 32 * len(live)
    assert units['idle_thread'] == 32 * (len(starts) - len(live))
    assert units['store_word'] == sum(min(gpw, groups - g) * bits
                                      for g in live) == groups * bits
    assert units['plane'] == n * bits


@pytest.mark.parametrize('n', [1, 3, 4, 5, 62006, 62008, 512, 513])
def test_dequant_units_cover_the_coordinates(n):
    """dequant's units on aligned rows: CPT coordinates a vector thread,
    one a tail thread, every coordinate once, and whole blocks."""
    cs = _chip_smoke()
    shape = build.constants('dequant')
    cpt, threads = shape['CPT'], shape['THREADS']
    units = cs.vector_units('dequant', n)
    assert (units['vector_thread'] * cpt + units['tail_thread']
            == units['coordinate'] == n)
    assert 0 <= units['tail_thread'] < cpt
    assert units['live_thread'] == units['vector_thread'] + \
        units['tail_thread'] <= units['thread']
    assert units['thread'] % threads == 0
    assert units['thread'] - units['live_thread'] < threads


@pytest.mark.parametrize('name', ['quantize', 'roundtrip'])
@pytest.mark.parametrize('n', [1, 3, 4, 5, 511, 512, 513, 515, 62006, 62008])
def test_quantize_and_roundtrip_units_cover_the_coordinates(name, n):
    """quantize's and roundtrip's units on aligned rows, as dequant's:
    CPT coordinates a vector thread, one a tail thread, every coordinate
    once, and whole blocks (n around the vector width and the tile)."""
    cs = _chip_smoke()
    shape = build.constants(name)
    cpt, threads = shape['CPT'], shape['THREADS']
    units = cs.vector_units(name, n)
    assert (units['vector_thread'] * cpt + units['tail_thread']
            == units['coordinate'] == n)
    assert 0 <= units['tail_thread'] < cpt
    assert units['live_thread'] == units['vector_thread'] + \
        units['tail_thread'] <= units['thread']
    assert units['thread'] % threads == 0
    assert units['thread'] - units['live_thread'] < threads
    assert set(cs.FUNCTION_OPS[name]) <= set(units)


@pytest.mark.parametrize('n,bits', [(62006, 3), (1007, 1), (1, 16)])
def test_api_work_counts_what_each_call_needs(n, bits):
    """The bytes that bound each kernel API call: every input the
    function needs read once, every output written once.  The roundtrip
    reads g and, by mod_ok, the uniforms or gbar (12 B a coordinate with
    its output, at either mod_ok); dequant the sign and the knob index
    or gbar (9 B); quantize g and the uniforms and writes a sign byte and
    a knob index (13 B).  unpack_dequant reads the sign words and, by
    mod_ok, the knob words or gbar, never both.  At l = 62,006 the
    roundtrip moves 744,088 B, unpack_dequant 279,048 B at mod_ok 1 and
    503,816 B at mod_ok 0."""
    cs = _chip_smoke()
    work = cs.api_work(n, bits)
    assert set(work) == set(cs.kernels_on('api'))
    assert work['roundtrip']['bytes'] == 12 * n + 16
    assert work['roundtrip']['variants']['mod_ok 0']['bytes'] == 12 * n + 16
    assert work['dequant']['bytes'] == 9 * n + 16
    assert work['dequant']['variants']['mod_ok 0']['bytes'] == 9 * n + 16
    assert work['quantize']['bytes'] == 13 * n + 8
    for name in ('quantize', 'dequant', 'roundtrip'):
        assert work[name]['units'] == cs.vector_units(name, n)
    groups = -(-n // 32)
    unpack = work['unpack_dequant']
    assert unpack['bytes'] == 4 * groups * (1 + bits) + 16 + 4 * n
    assert unpack['variants']['mod_ok 0']['bytes'] == 4 * groups + 8 * n + 16
    assert set(unpack['variants']) == {'mod_ok 0'}
    for name in ('unpack_bits', 'unpack_dequant'):
        assert work[name]['units'] == cs.unpack_units(name, n, bits)
    assert work['unpack_dequant']['variants']['mod_ok 0']['units'] == \
        unpack['units']
    if n == 62006:
        assert work['roundtrip']['bytes'] == 744088
        assert unpack['bytes'] == 279048
        assert unpack['variants']['mod_ok 0']['bytes'] == 503816


def test_main_path_picks_the_function_by_fingerprint(monkeypatch):
    """A library of several functions (quantize_pack has one per knob
    width): the spans belong to the one whose fingerprint they were read
    from; with none, the spans must be read anew."""
    funcs = sass.parse(LISTING)
    want = sass.fingerprint(funcs['_Z5otherv'])
    monkeypatch.setitem(sass.MAIN_PATHS, 'k', (want, {'thread': ((0, 0),)}))
    assert sass.main_path('k', funcs) is funcs['_Z5otherv']
    assert sass.main_path_mixes('k', funcs['_Z5otherv']) == {
        'thread': {'other': 1}}
    monkeypatch.setitem(sass.MAIN_PATHS, 'k', ('0' * 16, {}))
    with pytest.raises(RuntimeError, match='read the main-path spans anew'):
        sass.main_path('k', funcs)


@pytest.mark.parametrize('k,n,bits', [(20, 62006, 3), (1, 1, 1), (3, 257, 16),
                                      (33, 2049, 8), (2, 8192, 3)])
def test_quantize_pack_units_walk_the_grid(k, n, bits):
    """quantize_pack's units against a walk of its grid: block b, warp j
    of it owns groups from (b * THREADS / 32 + j) * GPW on, and a warp
    whose first group is past the last exits."""
    cs = _chip_smoke()
    shape = build.constants('quantize_pack')
    warps, gpw = shape['THREADS'] // 32, shape['GPW']
    groups = -(-n // 32)
    blocks = -(-groups // (warps * gpw))
    live = sum(1 for b in range(blocks) for j in range(warps)
               if (b * warps + j) * gpw < groups)
    units = cs.quantize_pack_units(k, n, bits)
    assert units['live_thread'] == k * live * 32
    # each live warp stores 1 + bits words per live group
    assert units['store_word'] == k * groups * (1 + bits)
    assert units['live_thread'] + units['idle_thread'] == \
        k * blocks * shape['THREADS']
    assert live * gpw * 32 >= n > (live - 1) * gpw * 32
    assert units['coordinate'] == k * n and units['plane'] == k * n * bits


@pytest.mark.parametrize('k,w', [(20, 5822), (20, 1943), (1, 1), (3, 192),
                                 (3, 193), (33, 40000)])
def test_corrupt_fold_units_cover_the_words(k, w):
    """corrupt_fold's units against a walk of its grid: a row's B blocks
    (at most MAX_BLOCKS, one per THREADS words) take slices of
    ceil(W / B) words, a thread one word per trip."""
    cs = _chip_smoke()
    shape = build.constants('corrupt_fold')
    threads = shape['THREADS']
    blocks = max(1, min(shape['MAX_BLOCKS'], -(-w // threads)))
    per = -(-w // blocks)
    trips = [len(range(min(w, b * per) + t, min(w, b * per + per), threads))
             for b in range(blocks) for t in range(threads)]
    units = cs.corrupt_fold_units(k, w)
    assert units['word'] == k * sum(trips) == k * w
    assert units['worker'] == k * sum(1 for n in trips if n)
    assert units['thread'] == k * blocks * threads
    # a row of one block writes its outputs itself: no atomics
    assert units['block'] == (k * blocks if blocks > 1 else 0)
    assert units['row'] == (k if blocks > 1 else 0)
