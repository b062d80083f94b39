"""The SASS instruction-mix reader (``repro_torch.kernels.sass``), on a
listing in ``cuobjdump -sass``'s format: the disassembler itself needs the
CUDA toolkit.  Also the kernel table of ``kernels.build`` and the
function operation counts that ``chip_smoke.py`` bounds each kernel by."""
import importlib.util
import pathlib

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


def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch):
    """An edited ``csrc/`` header renames (so rebuilds) the library of
    every source that includes it, and of no other."""
    monkeypatch.setattr(build, 'CSRC', tmp_path)
    (tmp_path / 'shared.cuh').write_text('#pragma once\n')
    (tmp_path / 'user.cu').write_text('#include <cstdint>\n'
                                      '#include "shared.cuh"\n')
    (tmp_path / 'alone.cu').write_text('#include <cstdint>\n')
    before = build.library_path('user'), build.library_path('alone')
    (tmp_path / 'shared.cuh').write_text('#pragma once\n// edited\n')
    after = build.library_path('user'), build.library_path('alone')
    assert after[0] != before[0] and after[1] == before[1]
    assert after[0].name.startswith('user-')
