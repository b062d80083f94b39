"""The port's sharding rules (``repro_torch.launch.shardings``) held to the
reference's (``repro.launch.shardings``) on the production meshes, for
all ten architectures at full width: the reference's rules run on a
``jax.sharding.AbstractMesh`` over ``jax.eval_shape`` trees (no devices),
the port's on its parameter and cache trees made on the meta device, and
each ``PartitionSpec`` becomes a tuple.  Then ``shard`` and ``unshard``
of small trees on small meshes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs.registry import ARCHITECTURES as REF_ARCHS
from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.launch import shardings as RS
from repro.models import transformer as RT
from repro_torch import tree
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCHITECTURES, get_arch
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import (MULTI_POD_AXES, MULTI_POD_SHAPE,
                                     SINGLE_POD_AXES, SINGLE_POD_SHAPE,
                                     coords_of)
from repro_torch.models import transformer as T

MESHES = {'pod16x16': (SINGLE_POD_SHAPE, SINGLE_POD_AXES),
          'pod2x16x16': (MULTI_POD_SHAPE, MULTI_POD_AXES)}
META = torch.device('meta')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _entry(e):
    return tuple(e) if isinstance(e, (list, tuple)) else e


def as_tuple(spec: PartitionSpec) -> tuple:
    return tuple(_entry(e) for e in spec)


def ref_specs(spec_tree) -> dict:
    """{dotted path: tuple} of a reference PartitionSpec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {}
    for path, spec in flat:
        names = [str(getattr(p, 'key', getattr(p, 'idx', p))) for p in path]
        out['.'.join(names)] = as_tuple(spec)
    return out


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


@pytest.mark.parametrize('mesh_name', sorted(MESHES))
@pytest.mark.parametrize('arch', sorted(ARCHITECTURES))
def test_param_specs_equal_the_references(arch, mesh_name):
    am, ms = meshes(mesh_name)
    rp = jax.eval_shape(lambda k: RT.init_params(REF_ARCHS[arch], k),
                        jax.random.PRNGKey(0))
    want = ref_specs(RS.param_specs(REF_ARCHS[arch], am, rp))
    cfg = get_arch(arch)
    params = T.init_params(cfg, torch.Generator(), device=META)
    got = S.param_specs(cfg, ms, params)
    assert got == want
    # the leaves' shapes are the reference's too
    assert S.shapes_of(params) == {
        p: tuple(x.shape) for p, x in zip(
            ['.'.join(str(getattr(k, 'key', k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(rp)[0]],
            jax.tree.leaves(rp))}


@pytest.mark.parametrize('shape_name', ['decode_32k', 'long_500k'])
@pytest.mark.parametrize('mesh_name', sorted(MESHES))
def test_cache_specs_equal_the_references(shape_name, mesh_name):
    am, ms = meshes(mesh_name)
    shape = INPUT_SHAPES[shape_name]
    ref_shape = REF_SHAPES[shape_name]
    for arch in sorted(ARCHITECTURES):
        rcfg = REF_ARCHS[arch]
        rc = jax.eval_shape(lambda: RT.init_cache(
            rcfg, ref_shape.global_batch, ref_shape.seq_len, jnp.bfloat16))
        want = ref_specs(RS.cache_specs(rcfg, am, ref_shape, rc))
        cfg = get_arch(arch)
        cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                             torch.bfloat16, device=META)
        assert S.cache_specs(cfg, ms, shape, cache) == want, arch
        assert S.decode_token_spec(cfg, ms, shape) == as_tuple(
            RS.decode_token_spec(rcfg, am, ref_shape)), arch


@pytest.mark.parametrize('mesh_name', sorted(MESHES))
def test_batch_and_client_specs_equal_the_references(mesh_name):
    am, ms = meshes(mesh_name)
    for arch in sorted(ARCHITECTURES):
        rcfg, cfg = REF_ARCHS[arch], get_arch(arch)
        for per_client in (True, False):
            want = {f: as_tuple(s) for f, s in RS.train_batch_specs(
                rcfg, am, per_client).items()}
            assert S.train_batch_specs(cfg, ms, per_client) == want, arch
        want = {f: as_tuple(s)
                for f, s in RS.prefill_batch_spec(rcfg, am).items()}
        assert S.prefill_batch_spec(cfg, ms) == want, arch
    for ndim in (1, 2, 3):
        assert S.client_spec(ms, ndim) == as_tuple(RS.client_spec(am, ndim))
    assert S.replicated(ms) == ()


@pytest.mark.parametrize('spec,shape', [
    (('model', None), (8, 6)), ((None, 'model'), (6, 8)),
    ((('data', 'model'), None), (12, 3)), (('x', 'y'), (5, 7))])
def test_sanitize_drops_what_does_not_divide(spec, shape):
    ms = {'data': 2, 'model': 4, 'x': 5, 'y': 2}
    want = tuple(None if e is None or d % int(np.prod(
        [ms[a] for a in S.entry_axes(e)])) else e
        for d, e in zip(shape, spec))
    assert S.sanitize_spec(spec, shape, ms) == want
    am = AbstractMesh(tuple(ms.values()), tuple(ms))
    ref = RS.sanitize_spec(PartitionSpec(*spec), shape, am)
    assert as_tuple(ref) == want


@pytest.mark.parametrize('mesh', [{'data': 2, 'model': 2},
                                  {'pod': 2, 'data': 2, 'model': 2},
                                  {'data': 1, 'model': 4}])
@pytest.mark.parametrize('arch', ['smollm-135m-reduced',
                                  'mamba2-130m-reduced',
                                  'arctic-480b-reduced'])
def test_shard_then_unshard_gives_back_the_tree(arch, mesh):
    cfg = get_arch(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(3))
    specs = S.param_specs(cfg, mesh, params)
    n = int(np.prod(list(mesh.values())))
    parts = [S.shard(params, specs, mesh, coords_of(mesh, r))
             for r in range(n)]
    for part in parts:
        for p, x in zip(tree.paths(part), tree.leaves(part)):
            assert tuple(x.shape) == S.block_shape(
                specs[p], tuple(tree.leaves(params)[
                    tree.paths(params).index(p)].shape), mesh)
    back = S.unshard(parts, specs, mesh, S.shapes_of(params))
    for a, b in zip(tree.leaves(back), tree.leaves(params)):
        assert torch.equal(a, b)
    # a sharded leaf's blocks partition it: their bytes add up to the
    # leaf's times its replication
    sizes = S.shapes_of(params)
    item = {p: 4 for p in sizes}
    total = S.block_bytes(sizes, specs, mesh, item) * n
    replicas = sum(int(np.prod(s)) * 4 * n // int(np.prod(
        [mesh[a] for e in specs[p] for a in S.entry_axes(e)] or [1]))
        for p, s in sizes.items())
    assert total == replicas


def test_cache_shard_then_unshard_on_the_sequence_axis():
    cfg = get_arch('gemma2-9b-reduced')
    mesh = {'data': 2, 'model': 2}
    shape = INPUT_SHAPES['long_500k']
    cache = T.init_cache(cfg, 1, 16, torch.float32)
    cache = tree.map(lambda x: torch.randn(x.shape), cache)
    specs = S.cache_specs(cfg, mesh, shape, cache)
    assert all(s[2] == ('data', 'model') for p, s in specs.items()
               if p.endswith(('.k', '.v')))
    parts = [S.shard(cache, specs, mesh, coords_of(mesh, r))
             for r in range(4)]
    back = S.unshard(parts, specs, mesh, S.shapes_of(cache))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(back),
                                                 tree.leaves(cache)))
