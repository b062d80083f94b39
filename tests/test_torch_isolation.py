"""The PyTorch port stands alone: importing every module of
``repro_torch`` loads neither JAX nor anything of the reference package
``repro``, and no source under ``src/repro_torch`` imports them.  Every
later slice of the port runs under this guard."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / 'src'
PKG = SRC / 'repro_torch'
MODULES = sorted(
    '.'.join(p.relative_to(SRC).with_suffix('').parts).removesuffix(
        '.__init__')
    for p in PKG.rglob('*.py'))
FORBIDDEN = re.compile(
    r'^\s*(import\s+(jax|repro)(\.|\s|$|,)|from\s+(jax|repro)(\.|\s))',
    re.MULTILINE)


def test_every_module_imports_without_jax_or_reference():
    code = (
        'import importlib, sys\n'
        f'for m in {MODULES!r}:\n'
        '    importlib.import_module(m)\n'
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
        "or m.startswith(('jax.', 'repro.')))\n"
        'print(len(sys.modules))\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, '-c', code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 20


@pytest.mark.parametrize('path', sorted(PKG.rglob('*.py')),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_source_does_not_import_jax_or_reference(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_chip_smoke_imports_nothing_of_jax_or_reference():
    text = (SRC.parent / 'chip_smoke.py').read_text()
    assert not FORBIDDEN.search(text)


def test_kernel_ab_imports_nothing_of_jax_or_reference():
    text = (SRC.parent / 'kernel_ab.py').read_text()
    assert not FORBIDDEN.search(text)


def test_the_zoo_and_serving_modules_are_under_the_guard():
    for name in ('repro_torch.models.moe', 'repro_torch.models.ssm',
                 'repro_torch.serving', 'repro_torch.serving.engine',
                 'repro_torch.launch.serve'):
        assert name in MODULES, name
