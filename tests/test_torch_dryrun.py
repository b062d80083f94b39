"""The port's dry run on the meta device (``repro_torch.launch.dryrun``),
each trace inside a fake process group that is destroyed after it
(``run_one`` and the ``fake_mesh`` helper below destroy it in a
``finally``), so no default group reaches another file's tests:

* a rank's bytes of the parameters, ḡ and the cache on the production
  meshes equal the bytes of the blocks the reference's specs give
  (``repro.launch.shardings`` on an ``AbstractMesh``, over
  ``jax.eval_shape`` trees), for all ten architectures at full width;
* on a (2, 2) mesh a rank's FLOPs equal the unsharded step's on the
  rank's own clients or rows (gather at use runs the whole forward), for
  the FL step, the standard step, prefill and decode;
* every (architecture x shape) that ``applicable`` skips is recorded as
  a skip, and the CLI writes one artifact a mesh and resumes.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.configs.registry import ARCHITECTURES as REF_ARCHS
from repro.launch import shardings as RS
from repro.models import transformer as RT
from repro_torch import tree
from repro_torch.configs.base import INPUT_SHAPES, FLConfig, ShapeConfig
from repro_torch.configs.registry import ARCHITECTURES, applicable, get_arch
from repro_torch.core import transport as tr
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (MULTI_POD_AXES, MULTI_POD_SHAPE,
                                     SINGLE_POD_AXES, SINGLE_POD_SHAPE,
                                     ProductionMesh)
from repro_torch.models import transformer as T
from repro_torch.training import distributed as D

MESHES = {False: (SINGLE_POD_SHAPE, SINGLE_POD_AXES),
          True: (MULTI_POD_SHAPE, MULTI_POD_AXES)}
SMALL = ((2, 2), ('data', 'model'))
META = torch.device('meta')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def ref_params_shape(arch: str):
    """The reference's parameter tree of ``arch`` as shapes (once a
    module)."""
    return jax.eval_shape(lambda k: RT.init_params(REF_ARCHS[arch], k),
                          jax.random.PRNGKey(0))


@contextlib.contextmanager
def fake_mesh(shape, axes, rank: int = 0):
    dryrun.fake_group(math.prod(shape), rank)
    try:
        yield ProductionMesh(shape, axes)
    finally:
        dist.destroy_process_group()


def ref_block_bytes(spec_tree, shape_tree, mesh_shape, itemsize=None) -> int:
    """Bytes of a rank's blocks under the reference's specs."""
    specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    out = 0
    for spec, leaf in zip(specs, jax.tree.leaves(shape_tree)):
        n = 1
        for dim, entry in zip(leaf.shape, list(spec) + [None] * leaf.ndim):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            n *= dim // math.prod(mesh_shape[a] for a in axes)
        out += n * (itemsize or jnp.dtype(leaf.dtype).itemsize)
    return out


@pytest.mark.parametrize('multi_pod', [False, True])
def test_rank_bytes_equal_the_references_specs(multi_pod):
    shape, axes = MESHES[multi_pod]
    am = AbstractMesh(shape, axes)
    ms = dict(zip(axes, shape))
    with fake_mesh(shape, axes) as mesh:
        for arch in sorted(ARCHITECTURES):
            rcfg, cfg = REF_ARCHS[arch], get_arch(arch)
            rp = ref_params_shape(arch)
            pspecs = RS.param_specs(rcfg, am, rp)
            st = dryrun.StepTrace(cfg, INPUT_SHAPES['train_4k'], mesh)
            st.arguments()
            assert st.memory['params'] == ref_block_bytes(pspecs, rp, ms)
            if 'gbar' in st.memory:
                assert st.memory['gbar'] == ref_block_bytes(pspecs, rp, ms,
                                                            itemsize=4)
                k_local = mesh.clients.k_local(mesh.clients.size)
                assert st.memory['grads'] == k_local * st.memory['params']
            else:
                assert arch == 'arctic-480b'
            for name in ('decode_32k', 'long_500k'):
                rs, shp = REF_SHAPES[name], INPUT_SHAPES[name]
                if not applicable(cfg, shp)[0]:
                    continue
                rc = jax.eval_shape(lambda: RT.init_cache(
                    rcfg, rs.global_batch, rs.seq_len, jnp.bfloat16))
                st = dryrun.StepTrace(cfg, shp, mesh)
                st.arguments()
                want = ref_block_bytes(RS.cache_specs(rcfg, am, rs, rc), rc,
                                       ms)
                assert st.memory['cache'] == want, (arch, name)


def _meta_like(t):
    return tree.map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device=META), t)


def _flops(fn) -> float:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())


def unsharded_flops(cfg, shape: ShapeConfig, k: int) -> float:
    """The step without a mesh on one rank's share of ``shape`` (``k``
    client ranks), on the meta device."""
    params = _meta_like(T.init_params(cfg, torch.Generator(), device=META))
    if shape.kind == 'train' and cfg.name.startswith('arctic-480b'):
        step = D.make_standard_train_step(cfg, FLConfig(n_devices=1))
        toks = torch.empty((shape.global_batch // k, shape.seq_len),
                           dtype=torch.int32, device=META)
        return _flops(lambda: step(params, {'tokens': toks}))
    if shape.kind == 'train':
        b = shape.global_batch // k
        step = D.make_fl_train_step(cfg, FLConfig(n_devices=1))
        toks = torch.empty((1, b, shape.seq_len), dtype=torch.int32,
                           device=META)
        gbar = tree.map(lambda x: torch.empty(x.shape, device=META), params)
        q = torch.empty((1,), device=META)
        sizes = [x.numel() for x in tree.leaves(params)]
        draws = tr.TreeDraws(dryrun.MetaUniforms(1, sizes),
                             sign_u=torch.empty((1, 1), device=META),
                             mod_u=torch.empty((1,), device=META))
        return _flops(lambda: step(params, {'tokens': toks}, gbar, q, q,
                                   draws))
    rows = shape.global_batch // k
    if shape.kind == 'prefill':
        toks = torch.empty((rows, shape.seq_len), dtype=torch.int32,
                           device=META)
        with torch.no_grad():
            return _flops(lambda: T.prefill(params, cfg, toks,
                                            shape.seq_len))
    cache = T.init_cache(cfg, rows, shape.seq_len, torch.bfloat16,
                         device=META)
    tok = torch.empty((rows, 1), dtype=torch.int32, device=META)
    with torch.no_grad():
        return _flops(lambda: T.decode_step(params, cfg, cache, tok,
                                            shape.seq_len - 1))


@pytest.mark.parametrize('arch,shape', [
    ('smollm-135m-reduced', ShapeConfig('tiny_train', 16, 8, 'train')),
    ('mamba2-130m-reduced', ShapeConfig('tiny_train', 16, 8, 'train')),
    ('arctic-480b-reduced', ShapeConfig('tiny_train', 16, 8, 'train')),
    ('smollm-135m-reduced', ShapeConfig('tiny_prefill', 32, 4, 'prefill')),
    ('mamba2-130m-reduced', ShapeConfig('tiny_decode', 32, 4, 'decode')),
    ('gemma2-9b-reduced', ShapeConfig('tiny_decode', 32, 4, 'decode'))])
def test_small_mesh_flops_equal_the_unsharded_steps(arch, shape):
    cfg = get_arch(arch)
    rec = dryrun.run_one(cfg, shape, out_dir=None, mesh_shape=SMALL, rank=3)
    assert not dist.is_initialized()
    assert rec['applicable'] and rec['n_devices'] == 4 and rec['rank'] == 3
    assert rec['step'] == {'train': 'standard_train' if arch.startswith(
        'arctic') else 'fl_train', 'prefill': 'prefill',
        'decode': 'decode'}[shape.kind]
    want = unsharded_flops(cfg, shape, 2)
    assert want > 0 and rec['cost']['flops'] == want
    coll = rec['collectives']
    assert coll['all-gather']['count'] > 0
    assert coll['all-gather']['bytes'] > 0
    if rec['step'] == 'fl_train':
        # the stats' sum, min and max over 'model'
        assert coll['all-reduce']['count'] == 3
    if rec['step'] == 'standard_train':
        assert coll['reduce-scatter']['count'] > 0
    mem = rec['memory']
    assert mem['peak_live_bytes'] >= mem['argument_size_in_bytes'] > 0
    assert mem['fits_80gb'] and rec['compile_s'] > 0


@pytest.mark.parametrize('multi_pod', [False, True])
def test_skips_are_recorded(multi_pod, tmp_path):
    skipped = 0
    for arch in sorted(ARCHITECTURES):
        for name in sorted(INPUT_SHAPES):
            ok, why = applicable(get_arch(arch), INPUT_SHAPES[name])
            if ok:
                continue
            rec = dryrun.run_one(arch, name, multi_pod, out_dir=str(tmp_path))
            assert rec['applicable'] is False and rec['skip_reason'] == why
            assert 'memory' not in rec
            on_disk = json.loads(open(rec['artifact']).read())
            assert on_disk['skip_reason'] == why
            assert on_disk['mesh'] == dryrun.mesh_name(multi_pod)
            skipped += 1
    assert skipped == 6          # the pure full-attention archs at 500k


def test_cli_writes_each_mesh_and_resumes(tmp_path, capsys):
    args = ['--arch', 'mamba2-130m', '--shape', 'long_500k', '--out-dir',
            str(tmp_path)]
    assert dryrun.main(args) == 0
    out = capsys.readouterr().out
    assert out.count('[OK]') == 2 and 'fits' in out
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ['mamba2-130m__long_500k__pod16x16.json',
                     'mamba2-130m__long_500k__pod2x16x16.json']
    rec = json.loads((tmp_path / files[1]).read_text())
    assert rec['n_devices'] == 512 and rec['step'] == 'decode'
    assert rec['memory']['cache_bytes'] > 0
    assert dryrun.main(args + ['--resume', '--single-pod']) == 0
    assert capsys.readouterr().out.count('[HAVE]') == 1
    assert not dist.is_initialized()
