"""Build and load the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, no ninja.  Libraries go to
``build/torch_kernels/`` at the repository root, named by a hash of the
source, the ``csrc/`` headers it includes and the flags, so an edited
source or header rebuilds and an unchanged one is reused.  All missing
libraries of one call are compiled in parallel (one ``nvcc`` process per
source).

The flags leave ``--use_fast_math`` off: float division must stay IEEE
(nvcc's default ``-prec-div=true``) or the stochastic quantizer's knob
indices drift from the reference.  ``-Xptxas -v`` has ptxas report each
function's registers and spills; the compiler's output is kept beside
the library (``<library>.log``, read by :func:`ptxas_report`).

Nothing here runs at import: the tests import every module on machines
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Tuple

CSRC = Path(__file__).resolve().with_name('csrc')
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / 'build' / 'torch_kernels'
ARCH = 'arch=compute_90a,code=sm_90a'
NVCC_FLAGS = ('-gencode', ARCH, '-std=c++17', '-O3', '-shared',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint32


class Kernel(NamedTuple):
    """One hand-written kernel: its ``csrc/<name>.cu`` source exports
    ``entry``."""
    entry: str         # C entry point; returns its launch's cudaError_t
    argtypes: list
    path: str          # 'round': the FL round; 'api': the *_flat kernel
    #                    API; 'alloc': the on-device eq. (28) solver
    replaces: str      # the TPU function it ports, as repo file:line


_PK = 'src/repro/wire/pack_kernel.py'
_QK = 'src/repro/kernels/quantize_kernel.py'
TABLE = {
    'quantize_pack': Kernel('spfl_quantize_pack',
                            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
                            'round', f'{_PK}:133'),
    'spfl_accumulate': Kernel('spfl_accumulate',
                              [_P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _P, _P,
                               _P, _P, _I, _I, _I, _P],
                              'round', f'{_PK}:169'),
    'corrupt_fold': Kernel('spfl_corrupt_fold',
                           [_P, _P, _P, _P, _P, _P, _P, _I, _I, _U, _U, _U,
                            _P],
                           'round', f'{_PK}:220'),
    'fold_words': Kernel('spfl_fold_words', [_P, _LL, _P, _I, _I, _P],
                         'round', f'{_PK}:263'),
    'quantize': Kernel('spfl_quantize', [_P, _P, _P, _P, _P, _P, _I, _I, _P],
                       'api', f'{_QK}:70'),
    'dequant': Kernel('spfl_dequant',
                      [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
                      'api', f'{_QK}:80'),
    'roundtrip': Kernel('spfl_roundtrip',
                        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
                        'api', f'{_QK}:96'),
    'pack_bits': Kernel('spfl_pack_bits', [_P, _P, _I, _I, _P],
                        'api', f'{_PK}:125'),
    'unpack_bits': Kernel('spfl_unpack_bits', [_P, _P, _I, _I, _P],
                          'api', f'{_PK}:129'),
    'unpack_dequant': Kernel('spfl_unpack_dequant',
                             [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
                             'api', f'{_PK}:159'),
    # the JAX engine's solve_traceable: one XLA program, no Pallas body
    'alloc_solve': Kernel('alloc_solve', [_P] * 18 + [_I] * 7 + [_P],
                          'alloc', 'src/repro/core/allocation_jax.py:584'),
}
KERNELS = tuple(TABLE)

_loaded: Dict[str, Tuple[ctypes.CDLL, object]] = {}


def nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = Path(home) / 'bin' / 'nvcc'
    if path.exists():
        return str(path)
    raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                       'machine with the CUDA toolkit')


def source(name: str) -> Path:
    return CSRC / f'{name}.cu'


def repo_source(name: str) -> str:
    """The source of kernel ``name`` as a path in the repository."""
    return (CSRC / f'{name}.cu').relative_to(ROOT).as_posix()


_CONSTANT = re.compile(r'^constexpr int (\w+) = (\d+);', re.M)


def constants(name: str) -> Dict[str, int]:
    """The integer constants that kernel ``name``'s source defines as
    ``constexpr int NAME = <literal>;`` at the start of a line: its launch
    shape, read where the host needs it."""
    text = (CSRC / f'{name}.cu').read_text()
    return {key: int(val) for key, val in _CONSTANT.findall(text)}


_LOCAL_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.M)


def library_path(name: str) -> Path:
    """The library of kernel ``name``, named by a hash of its source, the
    ``csrc/`` headers that the source includes and the flags."""
    text = source(name).read_bytes()
    headers = [(CSRC / h.decode()).read_bytes()
               for h in _LOCAL_INCLUDE.findall(text)]
    digest = hashlib.sha256(b'\0'.join([text, *headers])
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'{name}-{digest[:16]}.so'


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, all at once
    (one nvcc process each); -> {name: library path}.  Raises with the
    compiler's output if any build fails."""
    paths = {name: library_path(name) for name in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [exe, *NVCC_FLAGS, '-o', tmp, str(source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            os.unlink(tmp)
            errors.append(f'{name}: nvcc exit {proc.returncode}\n'
                          f'{out.decode(errors="replace")}')
        else:
            log = todo[name].with_suffix('.log')
            log.write_bytes(out)
            os.replace(tmp, todo[name])   # atomic: concurrent builders agree
    if errors:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(errors))
    return paths


def kernel(name: str):
    """The C entry point of kernel ``name``, built at first use."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(lib, TABLE[name].entry)
        fn.argtypes = TABLE[name].argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = (lib, fn)       # the CDLL stays referenced
    return _loaded[name][1]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use: for its
    entry points besides the kernel's own."""
    kernel(name)
    return _loaded[name][0]


_PTXAS_FUNC = re.compile(r"Function properties for (\S+)\s*\n\s*(\d+) bytes "
                         r"stack frame, (\d+) bytes spill stores, (\d+) "
                         r"bytes spill loads")
_PTXAS_REGS = re.compile(r"Compiling entry function '(\S+)'.*?\n"
                         r"(?:.*\n)*?.*?Used (\d+) registers")


def parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """``-Xptxas -v`` output -> {function: {'registers' (entry functions
    only), 'stack', 'spill_stores', 'spill_loads'}}."""
    out: Dict[str, Dict[str, int]] = {}
    for fn, stack, stores, loads in _PTXAS_FUNC.findall(text):
        out.setdefault(fn, {}).update(stack=int(stack),
                                      spill_stores=int(stores),
                                      spill_loads=int(loads))
    for fn, regs in _PTXAS_REGS.findall(text):
        out.setdefault(fn, {})['registers'] = int(regs)
    return out


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """What ptxas reported for each function of kernel ``name``'s
    library when it was built (:func:`parse_ptxas`); builds it if it is
    missing."""
    path = build([name])[name]
    return parse_ptxas(path.with_suffix('.log').read_text(errors='replace'))
