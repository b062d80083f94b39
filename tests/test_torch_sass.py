"""The SASS instruction-mix reader (``repro_torch.kernels.sass``), on a
listing in ``cuobjdump -sass``'s format: the disassembler itself needs the
CUDA toolkit.  Also the kernel table of ``kernels.build`` and the
function operation counts that ``chip_smoke.py`` bounds each kernel by."""
import importlib.util
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
    assert kern.path in ('round', 'api')
    path, line = kern.replaces.split(':')
    assert 'kernel' in (ROOT / path).read_text().splitlines()[int(line) - 1]
    fingerprint, units = sass.MAIN_PATHS[name]
    assert len(fingerprint) == 16 and int(fingerprint, 16) >= 0
    ops = cs.FUNCTION_OPS[name]
    assert ops and set(ops) <= set(units)
    assert all(set(mix) <= set(sass.PIPE_RATES) for mix in ops.values())


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
def other_sources(tmp_path):
    """``tmp_path`` as the ``csrc/`` that ``build`` builds from."""
    build.use_sources(tmp_path)
    yield tmp_path
    build.use_sources()


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


def test_use_sources_moves_the_build_and_not_the_repo_paths(tmp_path):
    """Another checkout's sources are built and hashed from there; the
    repository paths the results name stay this checkout's; and with no
    argument, this checkout's sources are in use again."""
    own = build.library_path('fold_words')
    (tmp_path / 'fold_words.cu').write_text('// an earlier version\n')
    build.use_sources(tmp_path)
    try:
        assert build.source('fold_words') == tmp_path / 'fold_words.cu'
        assert build.library_path('fold_words') != own
        assert build.repo_source('fold_words') == \
            'src/repro_torch/kernels/csrc/fold_words.cu'
    finally:
        build.use_sources()
    assert build.library_path('fold_words') == own


@pytest.mark.parametrize('name,keys', [
    ('spfl_accumulate', {'TILE', 'CHUNK', 'CPT'}),
    ('fold_words', {'CLUSTER', 'THREADS', 'UNROLL'})])
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
