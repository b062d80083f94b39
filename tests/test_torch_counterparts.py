"""The port does all that the reference does: every public top-level
function and class of ``src/repro/**`` has a counterpart of the same name
in the mirrored module of ``src/repro_torch/**``, a counterpart under
another name (``RENAMED``), or a one-line reason why PyTorch has none
(``JAX_ONLY``).  The Pallas bodies and their ``*_2d`` launchers are
``JAX_ONLY`` through ``PALLAS``: each names the hand-written kernel whose
``kernels/build.py`` ``TABLE`` row ``replaces`` that body.  Both trees are
read with ``ast``; the reference is never imported."""
import ast
import pathlib

import pytest

from repro_torch.kernels import build

SRC = pathlib.Path(__file__).resolve().parents[1] / 'src'
REF, PORT = SRC / 'repro', SRC / 'repro_torch'

# reference 'module::name' -> port 'module::name' ('Class.method' allowed)
RENAMED = {
    'models/cnn.py::init_cnn': 'models/cnn.py::init_params',
    'models/cnn.py::cnn_forward': 'models/cnn.py::CNN.forward',
    'kernels/ref.py::quantize_ref': 'kernels/ref.py::quantize',
    'kernels/ref.py::dequant_ref': 'kernels/ref.py::dequant',
    'kernels/ref.py::roundtrip_ref': 'kernels/ref.py::roundtrip',
    'kernels/ref.py::spfl_packed_aggregate_ref':
        'kernels/ref.py::spfl_accumulate',
}

# Pallas bodies and launchers -> the build.TABLE kernel that replaces them
PALLAS = {
    'wire/pack_kernel.py::pack_bits_kernel': 'pack_bits',
    'wire/pack_kernel.py::pack_2d': 'pack_bits',
    'wire/pack_kernel.py::unpack_bits_kernel': 'unpack_bits',
    'wire/pack_kernel.py::unpack_2d': 'unpack_bits',
    'wire/pack_kernel.py::quantize_pack_kernel': 'quantize_pack',
    'wire/pack_kernel.py::quantize_pack_2d': 'quantize_pack',
    'wire/pack_kernel.py::unpack_dequant_kernel': 'unpack_dequant',
    'wire/pack_kernel.py::unpack_dequant_2d': 'unpack_dequant',
    'wire/pack_kernel.py::spfl_accumulate_kernel': 'spfl_accumulate',
    'wire/pack_kernel.py::spfl_accumulate_2d': 'spfl_accumulate',
    'wire/pack_kernel.py::corrupt_fold_kernel': 'corrupt_fold',
    'wire/pack_kernel.py::corrupt_fold_2d': 'corrupt_fold',
    'wire/pack_kernel.py::fold_words_kernel': 'fold_words',
    'wire/pack_kernel.py::fold_words_2d': 'fold_words',
    'kernels/quantize_kernel.py::quantize_kernel': 'quantize',
    'kernels/quantize_kernel.py::quantize_2d': 'quantize',
    'kernels/quantize_kernel.py::dequant_kernel': 'dequant',
    'kernels/quantize_kernel.py::dequant_2d': 'dequant',
    'kernels/quantize_kernel.py::roundtrip_kernel': 'roundtrip',
    'kernels/quantize_kernel.py::roundtrip_2d': 'roundtrip',
}

JAX_ONLY = {
    'kernels/ops.py::default_interpret':
        'picks Pallas interpret mode off the TPU; a port wrapper runs its '
        "kernel or its plain version by the tensor's device",
    'kernels/ops.py::default_client_axes':
        'names the jax mesh axes of the client axis; core.mesh.ClientMesh '
        "holds a rank's rows instead",
    'kernels/quantize_kernel.py::quantize_body':
        'traced inside the quantize and roundtrip Pallas bodies; '
        'csrc/quantize.cu and csrc/roundtrip.cu compute it',
    'launch/dryrun.py::parse_collectives':
        "reads collectives out of XLA's HLO text; the port's dry run "
        'counts them on the meta device',
    'launch/dryrun.py::build_lowered':
        'builds a jax.jit lowering (HLO), which PyTorch has no counterpart '
        'of',
    'launch/shardings.py::param_shardings':
        'jax NamedSharding objects; the port keeps block specs '
        '(shardings.py) and model_axis.Layout',
    'launch/shardings.py::client_sharding':
        'a jax NamedSharding of the client axis; core.mesh.ClientMesh '
        'holds the rows',
    'launch/shardings.py::to_shardings':
        'turns PartitionSpecs into jax NamedSharding objects',
    'models/common.py::current_mesh_axes':
        'reads the abstract mesh of a jax trace',
    'models/common.py::maybe_constrain':
        "jax.lax.with_sharding_constraint under the trace's mesh (GSPMD "
        'hints)',
    'models/common.py::client_mesh_axes':
        "the client axes of the jax trace's mesh",
    'obs/ringbuf.py::ring_init_abstract':
        'the ring built from jax.eval_shape',
    'wire/corrupt.py::seeds_from_key':
        'derives the PRF seed words from a jax PRNG key; the port takes the '
        'words themselves (tests/test_torch_parity.seeds derives them)',
}
JAX_ONLY.update({name: f"Pallas code; ported as build.TABLE['{kernel}']"
                 for name, kernel in PALLAS.items()})


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text())


def _defs(module: ast.Module) -> dict:
    return {n.name: n for n in module.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}


def _public(path: pathlib.Path) -> list:
    return [name for name in _defs(_tree(path)) if not name.startswith('_')]


REF_MODULES = sorted(p.relative_to(REF).as_posix()
                     for p in REF.rglob('*.py'))


def _has(rel: str, dotted: str) -> bool:
    """``dotted`` ('name' or 'Class.method') is defined at the top of the
    port module ``rel``."""
    path = PORT / rel
    if not path.exists():
        return False
    node = _defs(_tree(path)).get(dotted.split('.')[0])
    for part in dotted.split('.')[1:]:
        if node is None or not isinstance(node, ast.ClassDef):
            return False
        node = _defs(node).get(part)
    return node is not None


@pytest.mark.parametrize('rel', REF_MODULES)
def test_every_reference_name_has_a_counterpart(rel):
    missing = [name for name in _public(REF / rel)
               if not _has(rel, name)
               and f'{rel}::{name}' not in RENAMED
               and f'{rel}::{name}' not in JAX_ONLY]
    assert not missing, (f'src/repro/{rel}: no counterpart in '
                         f'src/repro_torch/{rel} for {missing}')


@pytest.mark.parametrize('entry', sorted({**RENAMED, **JAX_ONLY}))
def test_every_entry_names_a_reference_function(entry):
    rel, name = entry.split('::')
    assert name in _public(REF / rel), entry
    # an entry whose name the port now has under the same name is stale
    assert not _has(rel, name), f'{entry} is in the port: drop the entry'


@pytest.mark.parametrize('entry', sorted(RENAMED))
def test_renamed_targets_exist(entry):
    rel, name = RENAMED[entry].split('::')
    assert _has(rel, name), RENAMED[entry]


@pytest.mark.parametrize('entry', sorted(JAX_ONLY))
def test_jax_only_entries_give_a_reason(entry):
    reason = JAX_ONLY[entry]
    assert isinstance(reason, str) and len(reason) > 20
    assert '\n' not in reason


def _pallas_body(rel: str, fn: ast.AST) -> str:
    """The body a launcher hands to ``pl.pallas_call`` (or ``fn`` itself
    when it is a body)."""
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == 'pallas_call'):
            names = {n.id for n in ast.walk(node.args[0])
                     if isinstance(n, ast.Name)}
            bodies = sorted(n for n in names if n.endswith('_kernel'))
            assert len(bodies) == 1, (rel, fn.name, bodies)
            return bodies[0]
    return fn.name


@pytest.mark.parametrize('entry', sorted(PALLAS))
def test_pallas_code_is_what_its_kernel_replaces(entry):
    rel, name = entry.split('::')
    defs = _defs(_tree(REF / rel))
    body = defs[_pallas_body(rel, defs[name])]
    kernel = build.TABLE[PALLAS[entry]]
    assert kernel.replaces == f'src/repro/{rel}:{body.lineno}', (
        entry, kernel.replaces)


def test_every_pallas_call_site_is_covered():
    """Each reference module holding a ``pl.pallas_call`` has its launchers
    in ``PALLAS``: no Pallas kernel is left without a port."""
    for rel in REF_MODULES:
        for name, fn in _defs(_tree(REF / rel)).items():
            calls = any(isinstance(n, ast.Attribute)
                        and n.attr == 'pallas_call' for n in ast.walk(fn))
            if calls:
                assert f'{rel}::{name}' in PALLAS, (rel, name)


def _exports(init: pathlib.Path) -> set:
    names = set()
    for node in _tree(init).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names


def test_wire_exports_every_reference_name():
    import repro_torch.wire as W
    want = _exports(REF / 'wire' / '__init__.py')
    assert len(want) > 30
    missing = sorted(n for n in want if not hasattr(W, n))
    assert not missing, missing
    assert want <= _exports(PORT / 'wire' / '__init__.py')
