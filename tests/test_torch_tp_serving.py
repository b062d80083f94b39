"""Prefill and decode on the 'model' axis of a production mesh
(``serving.generate(layout=)``, ``transformer.prefill``/``decode_step``
with ``tp`` and ``model_axis.Serving``) on the CPU: one spawn of 4 gloo
ranks at (data=2, model=2) (``python tests/test_torch_tp_serving.py
--worker``: every rank runs every case and writes its results and
logits), float32 ``-reduced`` variants, one of each rule:

* smollm-135m-reduced: a 'heads' attention (4 heads, 2 kv heads), the
  MLP and the vocabulary split;
* paligemma-3b-reduced: a 'q' attention (one kv head) and the prefix;
* mixtral-8x7b-reduced (capacity factor 8: no token drops, so a rank's
  rows route as the whole batch's): the experts split in f;
* mamba2-130m-reduced: the Mamba2 block's heads split (32 heads);
* zamba2-2.7b-reduced: Mamba2 beside Zamba2's shared attention block;
* smollm-3h-reduced (3 heads, 3 kv heads): an attention that does not
  divide, computed whole, its cache held at the reference's layout
  (``head_dim`` split) and gathered at use a layer at a time.

Each rank serves its row of a batch of 2 (rows split over 'data'):
the prefill's last logits and every held cache leaf against the
unsharded port's (the cache cut to the rank's block,
``launch.shardings.serving_cache_blocks``), then 4 greedy decode steps:
the logits within ``LOGIT_ATOL`` (1e-5) of the row's largest |logit|,
the greedy tokens equal.  ``generate`` with the layout returns the
unsharded ``generate``'s tokens.  On pytest's side the same logits are
held to the reference's ``repro.models.transformer.prefill`` and
``decode_step`` on the same weights and tokens.  A batch of 1 on the
same mesh splits the caches' sequence over ('data', 'model')
(long_500k's layout): 4 decode steps attended in place against the
whole-cache decode, on the attention models and gemma2-9b-reduced
(sliding window and soft-capping).
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / 'src'
WORLD, MESH = 4, ((2, 2), ('data', 'model'))
B, T, STEPS, CACHE = 2, 8, 4, 32
VARIANTS = {'smollm-3h-reduced': ('smollm-135m-reduced',
                                  {'n_heads': 3, 'n_kv_heads': 3}),
            'mixtral-8x7b-reduced': ('mixtral-8x7b-reduced',
                                     {'capacity_factor': 8.0})}
ARCHS = ('smollm-135m-reduced', 'paligemma-3b-reduced',
         'mixtral-8x7b-reduced', 'mamba2-130m-reduced',
         'zamba2-2.7b-reduced', 'smollm-3h-reduced')
# the partition at (data=2, model=2): attention, MLP, experts, vocab, SSM
PARTS = {'smollm-135m-reduced': ('heads', True, False, True, False),
         'paligemma-3b-reduced': ('q', True, False, True, False),
         'mixtral-8x7b-reduced': ('heads', False, True, True, False),
         'mamba2-130m-reduced': (None, False, False, True, True),
         'zamba2-2.7b-reduced': ('heads', True, False, True, True),
         'smollm-3h-reduced': (None, True, False, True, False)}
SEQ_ARCHS = ('smollm-135m-reduced', 'paligemma-3b-reduced',
             'zamba2-2.7b-reduced', 'gemma2-9b-reduced')
LOGIT_ATOL = 1e-5
CACHE_ATOL = 1e-5


def _arch(name: str, registry=None):
    import dataclasses
    if registry is None:
        from repro_torch.configs import registry
    base, changes = VARIANTS.get(name, (name, {}))
    return dataclasses.replace(registry.get_arch(base), **changes)


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, batch: int, seed: int = 0):
    """Weights from a seeded generator; tokens and a vision prefix from
    NumPy."""
    from repro_torch.models import transformer as tf
    params = tf.init_params(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (batch, T)).astype(np.int32)
    prefix = None
    if cfg.frontend == 'vision' and cfg.n_prefix_tokens:
        prefix = rng.randn(batch, cfg.n_prefix_tokens,
                           cfg.frontend_embed_dim).astype(np.float32)
    return params, toks, prefix


def _err(got, want) -> float:
    """The largest distance of each row over that row's largest |x|."""
    g = got.double().reshape(got.shape[0], -1)
    w = want.double().reshape(want.shape[0], -1)
    scale = torch.clamp(w.abs().amax(dim=1), min=1e-30)
    return float(((g - w).abs().amax(dim=1) / scale).max())


def _t(a):
    return None if a is None else torch.as_tensor(a)


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _decode_all(params, cfg, logits, cache, pos, tp=None, serving=None):
    """``STEPS`` greedy decode steps -> (the tokens fed, each step's
    logits)."""
    from repro_torch.models import transformer as tf
    toks, outs = [], []
    for i in range(STEPS):
        token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        logits, cache = tf.decode_step(params, cfg, cache, token, pos + i,
                                       tp, serving)
        toks.append(token)
        outs.append(logits)
    return torch.cat(toks, dim=1), torch.cat(outs, dim=1)


class Cases:
    def __init__(self, mesh):
        self.mesh = mesh
        self.out, self.arrays = {}, {}

    def serve(self, name: str) -> None:
        from repro_torch import tree
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import shardings as sh
        from repro_torch.models import transformer as tf
        from repro_torch.serving import engine
        from repro_torch.training import model_axis as MA
        cfg = _arch(name)
        params, toks, prefix = _inputs(cfg, B)
        layout = MA.Layout(cfg, self.mesh)
        tp = layout.tp
        blocks = MA.shard_params(params, layout)
        serving = MA.Serving(layout, cfg, ShapeConfig('s', CACHE, B,
                                                      'decode'))
        rows = serving.rows
        P = 0 if prefix is None else prefix.shape[1]
        with torch.no_grad():
            wl, wc = tf.prefill(params, cfg, torch.as_tensor(toks), CACHE,
                                _t(prefix), torch.float32)
            gl, gc = tf.prefill(blocks, cfg, torch.as_tensor(toks[rows]),
                                CACHE, None if prefix is None
                                else _t(prefix[rows]), torch.float32, tp,
                                serving)
            cache_err = 0.0
            kinds = {}
            # a cache held by heads is init_cache's under tp
            zero = tf.init_cache(cfg, 1, CACHE, torch.float32, tp=tp)
            same_shape = True
            for path, got, want, z in zip(tree.paths(gc), tree.leaves(gc),
                                          tree.leaves(wc), tree.leaves(zero)):
                kind, index = serving.blocks[path]
                kinds[path] = kind
                if kind == 'heads':
                    same_shape &= got.shape[2:] == z.shape[2:]
                want = sh.take(want, (slice(None),) + tuple(index))
                scale = max(float(want.abs().max()), 1e-30)
                cache_err = max(cache_err, float(
                    (got - want).abs().max()) / scale)
            wt, wd = _decode_all(params, cfg, wl, wc, P + T)
            gt, gd = _decode_all(blocks, cfg, gl, gc, P + T, tp, serving)
            tokens, _ = engine.generate(params, cfg, torch.as_tensor(toks),
                                        STEPS, CACHE, _t(prefix))
            split_tokens, split_logits = engine.generate(
                blocks, cfg, torch.as_tensor(toks), STEPS, CACHE, _t(prefix),
                layout=layout)
        self.out[name] = {
            'parts': [tp.attn, tp.mlp, tp.moe, tp.vocab, tp.ssm],
            'uses': sorted(set(layout.uses)), 'kinds': kinds,
            'prefill': _err(gl, wl[rows]), 'cache': cache_err,
            'init_cache': bool(same_shape),
            'decode': _err(gd, wd[rows]),
            'tokens': bool(torch.equal(gt, wt[rows])),
            'generate': bool(torch.equal(split_tokens, tokens)),
            'generate_logits': _err(split_logits, wl),
            'rows': [rows.start or 0, rows.stop or B]}
        self.arrays[f'{name}.prefill'] = gl.numpy()
        self.arrays[f'{name}.decode'] = gd.numpy()
        self.arrays[f'{name}.tokens'] = gt.numpy()

    def sequence(self, name: str) -> None:
        """A batch of 1: the caches' sequence split over ('data',
        'model'), decoded in place against the whole-cache decode."""
        from repro_torch import tree
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.models import transformer as tf
        from repro_torch.training import model_axis as MA
        cfg = _arch(name)
        params, toks, prefix = _inputs(cfg, 1, seed=2)
        layout = MA.Layout(cfg, self.mesh)
        blocks = MA.shard_params(params, layout)
        serving = MA.Serving(layout, cfg, ShapeConfig('s', CACHE, 1,
                                                      'decode'))
        P = 0 if prefix is None else prefix.shape[1]
        with torch.no_grad():
            wl, wc = tf.prefill(params, cfg, torch.as_tensor(toks), CACHE,
                                _t(prefix), torch.float32)
            gl, gc = tf.prefill(blocks, cfg, torch.as_tensor(toks), CACHE,
                                _t(prefix), torch.float32, layout.tp,
                                serving)
            held = {p: tuple(x.shape[2:]) for p, x in
                    zip(tree.paths(gc), tree.leaves(gc))}
            wt, wd = _decode_all(params, cfg, wl, wc, P + T)
            gt, gd = _decode_all(blocks, cfg, gl, gc, P + T, layout.tp,
                                 serving)
        self.out[f'{name}.sequence'] = {
            'kinds': {p: k for p, (k, _) in serving.blocks.items()},
            'held': held, 'decode': _err(gd, wd),
            'tokens': bool(torch.equal(gt, wt))}


def worker_main(rank: int, port: int, out_dir: Path) -> None:
    import torch.distributed as tdist
    torch.set_num_threads(1)
    tdist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                             rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import ProductionMesh
        mesh = ProductionMesh(*MESH)
        cases = Cases(mesh)
        for name in ARCHS:
            cases.serve(name)
        for name in SEQ_ARCHS:
            cases.sequence(name)
        cases.out['coords'] = mesh.coords
        (out_dir / f'rank{rank}.json').write_text(json.dumps(cases.out))
        np.savez(out_dir / f'rank{rank}.npz', **cases.arrays)
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# pytest's side
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def spawn(tmp_path_factory):
    """The 4 ranks' results and logits (one spawn for the file)."""
    out = tmp_path_factory.mktemp('tp_serving')
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [str(SRC)] + ([env['PYTHONPATH']] if env.get('PYTHONPATH') else []))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, '--worker', str(r), str(port), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errs = []
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=300)
            if proc.returncode:
                errs.append(f'rank {r}: {err[-3000:]}')
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not errs, '\n'.join(errs)
    return ([json.loads((out / f'rank{r}.json').read_text())
             for r in range(WORLD)],
            [dict(np.load(out / f'rank{r}.npz')) for r in range(WORLD)])


@pytest.fixture(scope='module')
def ranks(spawn):
    return spawn[0]


@pytest.mark.parametrize('arch', ARCHS)
def test_partition_and_cache_layout(ranks, arch):
    """The parts each rule splits; the cache held by heads where the
    partition splits them, at the reference's layout elsewhere."""
    res = ranks[0][arch]
    assert tuple(res['parts']) == PARTS[arch]
    attn, ssm = PARTS[arch][0], PARTS[arch][4]
    for path, kind in res['kinds'].items():
        split = ssm if path.split('.')[-1] in ('conv', 'ssm') else attn
        assert kind == ('heads' if split else 'reference'), (path, kind)
    if ssm:
        assert {'reblock', 'slice'} <= set(res['uses'])
    assert all(r[arch]['kinds'] == res['kinds'] for r in ranks)


@pytest.mark.parametrize('arch', ARCHS)
def test_split_serve_equals_the_unsharded_port(ranks, arch):
    for r in ranks:
        res = r[arch]
        assert res['rows'] == [r['coords']['data'], r['coords']['data'] + 1]
        assert res['prefill'] <= LOGIT_ATOL, res
        assert res['cache'] <= CACHE_ATOL and res['init_cache'], res
        assert res['decode'] <= LOGIT_ATOL, res
        assert res['tokens'], res


@pytest.mark.parametrize('arch', ARCHS)
def test_generate_with_a_layout(ranks, arch):
    """Every rank's ``generate(layout=)``: the whole batch's greedy tokens
    of the unsharded ``generate``, and its prefill logits."""
    for r in ranks:
        assert r[arch]['generate'], r[arch]
        assert r[arch]['generate_logits'] <= LOGIT_ATOL, r[arch]


@pytest.mark.parametrize('arch', SEQ_ARCHS)
def test_sequence_split_decode(ranks, arch):
    """A batch of 1: each K/V cache leaf holds a quarter of the slots
    (every kv head), decoded in place; the logits and greedy tokens of
    the whole-cache decode."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tf
    cfg = get_arch(arch)
    for r in ranks:
        res = r[f'{arch}.sequence']
        for path, kind in res['kinds'].items():
            if path.split('.')[-1] in ('k', 'v'):
                assert kind == 'sequence'
                slots, kv, _ = res['held'][path]
                layer = cfg.layer_pattern[int(path.split('.')[0][1:])]
                assert slots * WORLD == tf.entry_cache_len(cfg, layer,
                                                           CACHE)
                assert kv == cfg.n_kv_heads
        assert res['decode'] <= LOGIT_ATOL, res
        assert res['tokens'], res


@pytest.mark.parametrize('arch', ARCHS)
def test_split_serve_within_the_reference(spawn, arch):
    """The ranks' prefill and decode logits against the reference's
    ``prefill`` and ``decode_step`` on the same weights and tokens
    (its own greedy tokens, which the ranks' equal)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as RR
    from repro.models import transformer as RT
    from repro_torch import tree
    ranks, arrays = spawn
    rcfg, cfg = _arch(arch, RR), _arch(arch)
    params, toks, prefix = _inputs(cfg, B)
    rp = tree.unflatten(params, [jnp.asarray(x.numpy())
                                 for x in tree.leaves(params)])
    P = 0 if prefix is None else prefix.shape[1]
    logits, cache = jax.jit(RT.prefill, static_argnames=(
        'cfg', 'cache_len', 'cache_dtype'))(
        rp, rcfg, jnp.asarray(toks), CACHE,
        None if prefix is None else jnp.asarray(prefix), jnp.float32)
    step = jax.jit(RT.decode_step, static_argnames=('cfg',))
    prefill_logits = np.asarray(logits)
    outs, tokens = [], []
    for i in range(STEPS):
        token = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        tokens.append(np.asarray(token))
        logits, cache = step(rp, rcfg, cache, token, P + T + i)
        outs.append(np.asarray(logits))
    want_decode = np.concatenate(outs, axis=1)
    want_tokens = np.concatenate(tokens, axis=1)
    for r, arr in zip(ranks, arrays):
        rows = slice(*r[arch]['rows'])
        for got, want in ((arr[f'{arch}.prefill'], prefill_logits[rows]),
                          (arr[f'{arch}.decode'], want_decode[rows])):
            err = _err(torch.as_tensor(got), torch.as_tensor(want))
            assert err <= LOGIT_ATOL, (arch, err)
        np.testing.assert_array_equal(arr[f'{arch}.tokens'],
                                      want_tokens[rows])


if __name__ == '__main__':
    if sys.argv[1] == '--worker':
        worker_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
