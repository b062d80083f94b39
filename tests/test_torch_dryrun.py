"""The port's dry run on the meta device (``repro_torch.launch.dryrun``),
each trace inside a fake process group that is destroyed after it
(``run_one`` and the ``fake_mesh`` helper below destroy it in a
``finally``), so no default group reaches another file's tests:

* a rank's bytes of the parameters, ḡ and the cache on the production
  meshes equal the bytes of the blocks the reference's specs give
  (``repro.launch.shardings`` on an ``AbstractMesh``, over
  ``jax.eval_shape`` trees), for all ten architectures at full width;
  a serving cache leaf held by heads (``serving_cache_blocks``) holds
  the same bytes where its heads divide, a 'q' rank's one kv head
  ``model / kv`` times the reference's block (the reference splits
  ``head_dim``), a split Mamba2 conv window its heads' x channels with
  B and C whole;
* on a (2, 2) mesh a rank's FLOPs are the unsharded step's on the
  rank's own clients or rows less half of the products that tensor
  parallelism splits (``models.parallel``; counted from the shapes by
  :func:`parallel_flops`, a Mamba2 block's split measured on the block
  alone, whole and the rank's part, by :func:`mamba_split_flops`), for
  the FL step, the standard step, prefill and decode;
* a reduced serving record's peak falls below the unsharded serve's
  bytes of its whole model, and its FLOPs a rank by the split;
* every (architecture x shape) that ``applicable`` skips is recorded as
  a skip, and the CLI writes one artifact a mesh and resumes.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
from types import SimpleNamespace

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
from repro_torch.models import moe, parallel
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
                assert st.memory['cache'] == serving_cache_bytes(
                    cfg, shp, mesh, rcfg, rs, rc, am), (arch, name)


def serving_cache_bytes(cfg, shape, mesh, rcfg, rs, rc, am) -> int:
    """A rank's bytes of the serving cache (``serving_cache_blocks``),
    each leaf held against the reference's block of it."""
    from repro_torch.launch import shardings as sh
    ms = mesh.shape
    tp = parallel.partition(cfg, mesh.axis_mesh('model'))
    full = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                        torch.bfloat16, device=META)
    blocks = sh.serving_cache_blocks(cfg, mesh, shape, full, tp)
    specs = jax.tree.leaves(RS.cache_specs(rcfg, am, rs, rc),
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))
    total = 0
    for path, leaf, spec, ref in zip(tree.paths(full), tree.leaves(full),
                                     specs, jax.tree.leaves(rc)):
        kind, index = blocks[path]
        held = sh.index_shape(index, leaf.shape)
        ours = math.prod(held) * 2
        want = ref_block_bytes([spec], [ref], ms)
        if kind == 'heads':
            # cut by heads (kv heads, conv channels, SSM heads: the one
            # dimension past the batch that the index cuts), where the
            # reference cuts 'model' ranks' worth of another dimension
            (d,) = [d for d in range(2, len(held)) if held[d] < leaf.shape[d]]
            m_ref = math.prod(tp.size for e in spec if e == 'model')
            assert ours * leaf.shape[d] == want * m_ref * held[d], path
            name = path.split('.')[-1]
            assert (held[d] * tp.size == leaf.shape[d]) == (
                name == 'ssm' or tp.attn == 'heads' and name in ('k', 'v'))
        else:
            assert ours == want, (path, kind)
        total += ours
    return total


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


def mamba_split_flops(cfg, b: int, t: int, kind: str, model: int = 2
                      ) -> float:
    """FLOPs of one Mamba2 block in the products that a split SSM divides
    over ``model`` ranks: the block whole less the rank's part
    (``mamba_forward`` or ``mamba_decode`` with the rank's compute
    blocks, its collectives the one-rank mesh's identity), each under
    ``FlopCounterMode`` on the meta device, over 1 - 1 / ``model``; a
    train step's block runs forward, then again and backward
    (``remat_policy`` 'full')."""
    from repro_torch.core.mesh import ClientMesh
    from repro_torch.models import ssm
    tp = parallel.partition(cfg, SimpleNamespace(size=model, rank=0))
    if not tp.ssm:
        return 0.0
    tp = parallel.TensorParallel(
        mesh=ClientMesh(), rank=0, size=model, attn=None, kv_head=0,
        mlp=False, moe=False, vocab=False, ssm=True)
    whole = ssm.init_mamba(torch.Generator(), cfg, torch.float32, META)
    heads = parallel.ssm_heads(cfg, 0, model)
    cols = {'in_proj': parallel.ssm_columns(cfg, 0, model),
            'conv_w': parallel.conv_channels(cfg, 0, model),
            'conv_b': parallel.conv_channels(cfg, 0, model)}
    inner = cfg.ssm_inner // model
    part = {}
    for name, x in whole.items():
        if name in cols:
            part[name] = x[..., :len(cols[name])]
        elif name in ('A_log', 'D', 'dt_bias'):
            part[name] = x[heads]
        elif name == 'norm_scale':
            part[name] = x[:inner]
        else:
            part[name] = x[:inner]
    u = torch.empty((b, t, cfg.d_model), device=META)

    def count(p, split) -> float:
        sp = tp if split else None
        if kind == 'decode':
            cache = ssm.init_mamba_cache(cfg, b, torch.bfloat16, META, sp)
            with torch.no_grad():
                return _flops(lambda: ssm.mamba_decode(p, cfg, u[:, :1],
                                                       cache, sp))
        if kind == 'prefill':
            with torch.no_grad():
                return _flops(lambda: ssm.mamba_forward(
                    p, cfg, u, return_cache=True, tp=sp))
        with torch.no_grad():
            fwd = _flops(lambda: ssm.mamba_forward(p, cfg, u, tp=sp))
        leaves = [x.requires_grad_(True) for x in p.values()]
        ui = u.clone().requires_grad_(True)

        def both():
            y = ssm.mamba_forward(dict(zip(p, leaves)), cfg, ui, tp=sp)
            torch.autograd.grad(y.sum(), [ui] + leaves)
        return fwd + _flops(both)

    return (count(whole, False) - count(part, True)) * model / (model - 1)


def parallel_flops(cfg, b: int, t: int, model: int = 2, kind: str = 'train',
                   cache_len: int = 0) -> float:
    """FLOPs of one step on (b, t) tokens (decode: b tokens against a
    cache of ``cache_len``) in the products that tensor parallelism
    splits over ``model`` ranks, from the shapes: the attention
    projections and its two einsums ('heads'), the MLP's three
    products, the experts' three einsums (capacity ``expert_capacity``),
    the head's product, and a Mamba2 block's split
    (:func:`mamba_split_flops`).  A train step's group product runs
    forward, again under ``remat_policy`` 'full' and twice backward (the
    input's and the weight's gradients), the head's forward and twice
    backward; prefill's head takes the last position."""
    tp = parallel.partition(cfg, SimpleNamespace(size=model, rank=0))
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    n = b * (1 if kind == 'decode' else t)
    group = 0
    mamba = 0.0
    for lk in cfg.layer_pattern:
        if lk == 'mamba':
            mamba += mamba_split_flops(cfg, b, t, kind, model)
            continue
        if tp.attn == 'heads':
            tq = 1 if kind == 'decode' else t
            s = T.entry_cache_len(cfg, lk, cache_len) if kind == 'decode' \
                else t
            group += 2 * n * d * hd * (2 * h + 2 * kv)
            group += 2 * 2 * b * h * tq * s * hd
        if tp.mlp:
            group += 3 * 2 * n * d * cfg.d_ff
        if tp.moe:
            group += 3 * 2 * cfg.n_experts * moe.expert_capacity(n, cfg) \
                * d * cfg.d_ff
    assert cfg.remat_policy == 'full' and tp.attn != 'q'
    ng = T.n_groups(cfg)
    out = (4 if kind == 'train' else 1) * ng * group + ng * mamba
    if tp.vocab:
        out += (3 * 2 * b * (t - 1) * d * cfg.vocab_size if kind == 'train'
                else 2 * b * d * cfg.vocab_size)
    return float(out)


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
    split = parallel_flops(cfg, shape.global_batch // 2, shape.seq_len,
                           kind=shape.kind, cache_len=shape.seq_len)
    assert want > 0 and split > 0
    assert rec['cost']['flops'] == want - split / 2
    coll = rec['collectives']
    assert coll['all-gather']['count'] > 0
    assert coll['all-gather']['bytes'] > 0
    if rec['step'] == 'fl_train':
        # the stats' sum, min and max over 'model', and the sums of the
        # tensor-parallel layers
        n = coll['all-reduce']['count']
        assert n == 3 if split == 0 else n > 3
    if rec['step'] == 'standard_train':
        assert coll['reduce-scatter']['count'] > 0
    mem = rec['memory']
    assert mem['peak_live_bytes'] >= mem['argument_size_in_bytes'] > 0
    assert mem['fits_80gb'] and rec['compile_s'] > 0


@pytest.mark.parametrize('arch,shape', [
    ('smollm-135m-reduced', ShapeConfig('tiny_prefill', 32, 4, 'prefill')),
    ('mamba2-130m-reduced', ShapeConfig('tiny_decode', 32, 4, 'decode')),
    ('zamba2-2.7b-reduced', ShapeConfig('tiny_decode', 32, 4, 'decode'))])
def test_small_mesh_serving_peak_below_the_whole_model(arch, shape):
    """A serving record of an 8-group variant on the (2, 2) mesh: its
    peak live bytes below the bytes of the whole model (the unsharded
    serve holds all of them; a rank takes one group's weights at a
    time), its FLOPs a rank the unsharded step's less half the split."""
    import dataclasses
    base = get_arch(arch)
    cfg = dataclasses.replace(base, n_layers=8 * len(base.layer_pattern))
    whole = sum(x.numel() * x.element_size() for x in tree.leaves(
        T.init_params(cfg, torch.Generator(), device=META)))
    rec = dryrun.run_one(cfg, shape, out_dir=None, mesh_shape=SMALL, rank=1)
    assert rec['memory']['peak_live_bytes'] < whole, (rec['memory'], whole)
    split = parallel_flops(cfg, shape.global_batch // 2, shape.seq_len,
                           kind=shape.kind, cache_len=shape.seq_len)
    assert rec['cost']['flops'] == unsharded_flops(cfg, shape, 2) - split / 2


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
    assert dryrun.main(['--report', str(tmp_path)]) == 0
    assert capsys.readouterr().out.endswith(
        '2 of 2 applicable records (2 in all) fit 80 GB a rank by their '
        'peak, 2 at rest\n')
