"""The 'model' axis of a production mesh (``launch.mesh.ProductionMesh``,
``training.model_axis``) on the CPU: one spawn of 4 gloo ranks at
(data=2, model=2) (``python tests/test_torch_model_axis.py --worker``:
every rank runs every case and writes its results and gradient blocks),
on smollm-135m-reduced (4 heads, 2 kv heads, d_ff 512, vocab 512: every
tensor-parallel kind of ``models.parallel``), paligemma-3b-reduced (one
kv head: ``wk/wv`` gathered, the query heads split),
mamba2-130m-reduced (its 32 SSM heads split: ``in_proj``, ``conv_w`` and
``conv_b`` re-blocked by one all-to-all, ``A_log``, ``D`` and ``dt_bias``
sliced; the vocabulary split), mixtral-3e-reduced (mixtral-8x7b-reduced
with 3 experts, which stay off the client axes: its experts split in f
inside the FL step's vmap) and zamba2-2.7b-reduced (Mamba2 split beside
the shared attention block).

Each FL case is held to the step without the 'model' axis on the same
rank's clients and the same draws (the parameters whole on the rank; the
packed wire's client axis sharded as ``collective='sharded'``; the
analytic wire's client rows gathered):

* each per-client gradient block against the same slice of the
  unsharded pass's gradients (every architecture here takes tensor
  parallelism at model = 2) within ``GRAD_ATOL`` (1e-5) of the leaf's
  largest |g| (its row-parallel sums regroup), the losses within
  ``LOSS_RTOL`` (1e-6) relative; on the pytest side the blocks are also
  held within ``GRAD_ATOL`` of the reference's
  ``jax.value_and_grad(repro.models.transformer.loss_fn)`` sliced the
  same way (``tests/test_torch_zoo.py``'s scaled atol);
* given the same gradient blocks (the unsharded step handed the tensor-
  parallel gradients, gathered), the integers are exact: the knob
  indices and sign bits of each block (analytic wire), each leaf's packed
  sign and knob words (packed wire), ``sign_ok``, ``mod_ok``, the bit
  channel's flips and CRC verdicts, and ``g_min``/``g_max`` (an
  all-reduce MIN/MAX);
* the new parameters and ḡ are within 9.9e-8 of each leaf's largest
  magnitude (the bound the sharded collective holds for reordered float32
  sums), and ||g_k||^2 within (2 L + 2) eps relative, L the leaves
  (``model_axis.g2_rtol``: each leaf's block sums and its share of the
  all-reduce over 'model' round once more).

The standard step (``make_standard_train_step(mesh=)``) on the rank's
rows of the global batch takes the mean of the client ranks' mean losses
and gradients (``model_axis.standard_grads``): its gradient blocks are
within ``GRAD_ATOL`` of each leaf's largest |g| of the mean of the
unsharded gradients on each client rank's rows and of the reference's,
its new parameters within lr x ``GRAD_ATOL`` of that largest |g| (and
one float32 rounding) of p - lr x that mean, its loss within
``LOSS_RTOL``, on smollm-135m-reduced,
arctic-480b-reduced and mixtral-8x7b-reduced, whose four experts split
over 'data' (expert parallelism: the reduce-scatter) and over 'model' in
f (tensor parallelism).  On the dense model that is also the whole
batch's step: its update within 1e-4 of the whole batch step's largest
update (each gradient's sum over the batch rows regrouped as two
halves).  A MoE's capacity and load-balance loss are per batch, so a
MoE's whole-batch step is another function.  The FL step refuses a tree
split over the client axes.  Without a spawn, ``parallel.partition`` and
each leaf's use are held at the production (data=16, model=16) for all
ten architectures and every model rank (no Mamba2 leaf gathered where
its heads divide).  The re-block use's bytes: one all-to-all a leaf each
way, a rank receiving exactly its compute blocks forward and sending
them back backward (``test_reblock_moves_one_block_each_way``).
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
K, B, T = 4, 2, 16
# mixtral-3e-reduced: mixtral-8x7b-reduced with 3 experts, which do not
# divide 'data' and so stay off the client axes: the FL step takes it,
# its experts split in f inside the vmap over the rank's clients
VARIANTS = {'mixtral-3e-reduced': ('mixtral-8x7b-reduced',
                                   {'n_experts': 3})}
ARCHS = ('smollm-135m-reduced', 'paligemma-3b-reduced',
         'mamba2-130m-reduced', 'mixtral-3e-reduced', 'zamba2-2.7b-reduced')
STANDARD = ('smollm-135m-reduced', 'arctic-480b-reduced',
            'mixtral-8x7b-reduced')
# the parts each architecture splits at (data=2, model=2): attention,
# MLP, experts, vocabulary, SSM (mamba2-reduced's 32 heads divide 2)
PARTS = {'smollm-135m-reduced': ('heads', True, False, True, False),
         'paligemma-3b-reduced': ('q', True, False, True, False),
         'mamba2-130m-reduced': (None, False, False, True, True),
         'arctic-480b-reduced': ('heads', True, True, True, False),
         'mixtral-8x7b-reduced': ('heads', False, True, True, False),
         'mixtral-3e-reduced': ('heads', False, True, True, False),
         'zamba2-2.7b-reduced': ('heads', True, False, True, True)}
WIRES = ('analytic', 'packed')
PARAM_RTOL = 9.9e-8
WHOLE_BATCH_RTOL = 1e-4
GRAD_ATOL = 1e-5
LOSS_RTOL = 1e-6


def _arch(name: str, registry=None):
    """The configuration ``name`` from ``registry`` (the port's by
    default), a variant of ``VARIANTS`` included."""
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


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _inputs(cfg, seed: int = 0):
    from repro_torch import tree
    from repro_torch.core import transport as tr
    from repro_torch.models import transformer as tf
    g = torch.Generator().manual_seed(seed)
    params = tf.init_params(cfg, g)
    toks = torch.randint(0, cfg.vocab_size, (K, B, T), generator=g,
                         dtype=torch.int32)
    prefix = None
    if cfg.frontend == 'vision' and cfg.n_prefix_tokens:
        prefix = torch.randn((K, B, cfg.n_prefix_tokens,
                              cfg.frontend_embed_dim), generator=g)
    gbar = tree.map(lambda p: torch.rand(p.shape, generator=g) * 0.01,
                    params)
    q = 0.5 + 0.5 * torch.rand(K, generator=g)
    p = 0.5 + 0.5 * torch.rand(K, generator=g)
    sizes = [x.numel() for x in tree.leaves(params)]
    rand = [torch.rand((K, n), generator=g) for n in sizes]
    host = {c: tr.tree_host_draws(K, len(sizes), 0, c, g)
            for c in ('bitlevel', 'bernoulli')}
    return params, toks, prefix, gbar, q, p, rand, host


def _rel(a, b) -> float:
    scale = max(float(b.abs().max()), 1e-30)
    return float((a.double() - b.double()).abs().max()) / scale


def _err(block, want_block, want) -> float:
    """A block's distance from the same block of ``want`` over the
    leaf's largest |g| (all of ``want``)."""
    scale = max(float(want.abs().max()), 1e-30)
    return float((block.double() - want_block.double()).abs().max()) / scale


def _batch(toks, prefix, rows):
    out = {'tokens': toks[rows]}
    if prefix is not None:
        out['prefix'] = prefix[rows]
    return out


class Cases:
    def __init__(self, mesh):
        self.mesh = mesh
        self.out = {}
        self.arrays = {}

    def arch(self, name: str) -> None:
        from unittest import mock

        from repro_torch import tree
        from repro_torch.configs.base import FLConfig
        from repro_torch.core import transport as tr
        from repro_torch.core.mesh import pad_rows
        from repro_torch.kernels import ops as kops
        from repro_torch.training import distributed as D
        from repro_torch.training import model_axis as MA
        cfg = _arch(name)
        mesh, cm = self.mesh, self.mesh.clients
        params, toks, prefix, gbar, q, p, rand, host = _inputs(cfg)
        layout = MA.Layout(cfg, mesh)
        tp = layout.tp
        self.out[f'{name}.parts'] = [tp.attn, tp.mlp, tp.moe, tp.vocab,
                                     tp.ssm, layout.uses]
        rows = cm.rows(K)
        blocks = MA.shard_params(params, layout)
        gb_blocks = MA.shard_params(gbar, layout)
        pre = None if prefix is None else prefix[rows]
        # the per-client gradient blocks
        losses, got = MA.client_grads(blocks, cfg, toks[rows], layout,
                                      prefix=pre)
        want_losses, want = D.client_grads(params, cfg, toks[rows],
                                           prefix=pre)
        want = tree.leaves(want)
        self.out[f'{name}.grads'] = {
            'sharded': sum(bool(MA._sharded_dims(s)) for s in layout.specs),
            'equal': all(torch.equal(a, layout.block_of(i, b, 1))
                         for i, (a, b) in enumerate(zip(got, want))),
            'err': max(_err(a, layout.block_of(i, b, 1), b)
                       for i, (a, b) in enumerate(zip(got, want))),
            'loss': _rel(losses, want_losses)}
        for i, a in enumerate(got):
            self.arrays[f'{name}.fl.{i}'] = a.numpy()
        # the step without the 'model' axis is handed these gradients
        whole = [MA.gather_full(mesh, a, s, lead=1)
                 for a, s in zip(got, layout.specs)]
        k_l = cm.k_local(K)
        every = [cm.gather_rows(pad_rows(x, k_l), K) for x in whole]
        every_losses = cm.gather_rows(pad_rows(losses, k_l), K)

        def same_grads(params_, cfg_, tokens, deterministic=False,
                       prefix=None):
            if tokens.shape[0] == K:
                return every_losses, tree.unflatten(params, every)
            return losses, tree.unflatten(params, whole)

        stats = MA.model_stats(got, layout)
        ref_stats = tr.tree_client_stats(whole)
        bits = FLConfig().quant_bits
        # the integers on the wire: knob indices and signs of each block
        # (analytic), each leaf's sign and knob words (packed)
        lo, hi = stats['g_min'], stats['g_max']
        bd = MA.BlockDraws(rand, layout)
        knobs = words = True
        for i, (a, b) in enumerate(zip(got, whole)):
            mine = tr.stochastic_quantize(
                a.reshape(a.shape[0], -1), bits, bd[i][rows], lo[:, None],
                hi[:, None])
            full = tr.stochastic_quantize(
                b.reshape(b.shape[0], -1), bits, rand[i][rows],
                ref_stats['g_min'][:, None], ref_stats['g_max'][:, None])
            kfull = full.qidx.reshape(b.shape)
            sfull = full.sign.reshape(b.shape)
            knobs &= torch.equal(mine.qidx.reshape(a.shape),
                                 layout.block_of(i, kfull, 1))
            knobs &= torch.equal(mine.sign.reshape(a.shape),
                                 layout.block_of(i, sfull, 1))
            sw, qw = kops.quantize_pack_flat(
                b.reshape(a.shape[0], -1).float().contiguous(),
                rand[i][rows], lo, hi, bits)
            rsw, rqw = kops.quantize_pack_flat(
                b.reshape(b.shape[0], -1).float().contiguous(),
                rand[i][rows], ref_stats['g_min'], ref_stats['g_max'], bits)
            words &= torch.equal(sw, rsw) and torch.equal(qw, rqw)
        self.out[f'{name}.wire'] = {'knobs': bool(knobs),
                                    'words': bool(words)}
        for wire in WIRES:
            chan = 'bitlevel' if wire == 'packed' else 'bernoulli'
            coll = 'sharded' if wire == 'packed' else 'gather'
            fl = FLConfig(n_devices=K, wire=wire, channel=chan,
                          collective=coll)
            draws = tr.TreeDraws(rand, **host[chan])
            step = D.make_fl_train_step(cfg, fl, mesh=mesh)
            new_p, new_g, m = step(blocks, _batch(toks, prefix, rows),
                                   gb_blocks, q, p, draws)
            with mock.patch.object(D, 'client_grads', same_grads):
                if coll == 'sharded':
                    ref = D.make_fl_train_step(cfg, fl, mesh=cm)
                    rp, rg, rm = ref(params, _batch(toks, prefix, rows),
                                     gbar, q, p, draws)
                else:
                    ref = D.make_fl_train_step(cfg, fl)
                    rp, rg, rm = ref(params, _batch(toks, prefix,
                                                    slice(None)),
                                     gbar, q, p, draws)
            ints = ['sign_ok', 'mod_ok', 'g_min', 'g_max']
            tel = m['telemetry']
            rtel = rm['telemetry']
            if chan == 'bitlevel':
                ints_tel = ('sign_flips', 'mod_flips', 'sign_crc_ok',
                            'mod_crc_ok')
            else:
                ints_tel = ()
            self.out[f'{name}.{wire}'] = {
                'ints': {f: bool(torch.equal(m[f], rm[f])) for f in ints}
                | {f: bool(torch.equal(getattr(tel, f), getattr(rtel, f)))
                   for f in ints_tel},
                'params': max(_rel(a, layout.block_of(i, b)) for i, (a, b)
                              in enumerate(zip(tree.leaves(new_p),
                                               tree.leaves(rp)))),
                'gbar': max(_rel(a, layout.block_of(i, b)) for i, (a, b)
                            in enumerate(zip(tree.leaves(new_g),
                                             tree.leaves(rg)))),
                'g2': float(((m['g_norm_sq'] - rm['g_norm_sq'])
                             / rm['g_norm_sq']).abs().max()),
                'g2_bound': MA.g2_rtol(len(layout.paths)),
                'loss': float((m['client_losses']
                               - rm['client_losses']).abs().max())}

    def reblock_bytes(self, name: str) -> None:
        """The bytes each re-block all-to-all of one client's forward and
        backward moves (``ClientMesh.all_to_all`` recorded), against the
        rank's compute blocks and the gather's ``size`` stored blocks."""
        from unittest import mock

        from repro_torch import tree
        from repro_torch.core.mesh import ClientMesh
        from repro_torch.models import transformer as tf
        from repro_torch.training import model_axis as MA
        cfg = _arch(name)
        params, toks, *_ = _inputs(cfg)
        layout = MA.Layout(cfg, self.mesh)
        blocks = [b.detach().requires_grad_(True)
                  for b in tree.leaves(MA.shard_params(params, layout))]
        moved = []
        orig = ClientMesh.all_to_all

        def record(mesh, t, out_splits, in_splits):
            out = orig(mesh, t, out_splits, in_splits)
            moved.append((t.numel() * t.element_size(),
                          out.numel() * out.element_size()))
            return out

        with mock.patch.object(ClientMesh, 'all_to_all', record):
            used = tree.unflatten(params, layout.used(blocks))
            n_fwd = len(moved)
            loss = tf.loss_fn(used, cfg, toks[0], tp=layout.tp)
            torch.autograd.grad(loss, blocks)
        fwd, bwd = moved[:n_fwd], moved[n_fwd:]
        # a block's gradient in the block's own dtype: float32 blocks of
        # a bf16 configuration's layout (a float32 copy of its weights)
        import dataclasses
        layout16 = MA.Layout(dataclasses.replace(
            cfg, param_dtype='bfloat16'), self.mesh)
        loss16 = tf.loss_fn(tree.unflatten(params, layout16.used(blocks)),
                            cfg, toks[0], tp=layout16.tp)
        dtypes = {str(g.dtype) for g in torch.autograd.grad(loss16, blocks)}
        compute = stored = 0
        for i, plan in layout.reblock.items():
            lead = torch.Size(layout.shapes[i][:-1]).numel()
            compute += sum(plan.recv_counts) * lead * 4
            stored += plan.n * lead * 4
        self.out[f'{name}.reblock'] = {
            'leaves': len(layout.reblock), 'calls': [len(fwd), len(bwd)],
            'fwd_sent': sum(a for a, _ in fwd),
            'fwd_received': sum(b for _, b in fwd),
            'bwd_sent': sum(a for a, _ in bwd),
            'bwd_received': sum(b for _, b in bwd),
            'compute': compute, 'stored': stored,
            'gather': stored * layout.tp.size,
            'bc': 2 * cfg.ssm_state, 'f32_copy_dtypes': sorted(dtypes)}

    def standard(self, name: str) -> None:
        from repro_torch import tree
        from repro_torch.configs.base import FLConfig
        from repro_torch.core.quantize import true_div
        from repro_torch.models import transformer as tf
        from repro_torch.training import distributed as D
        from repro_torch.training import model_axis as MA
        cfg = _arch(name)
        mesh, cm = self.mesh, self.mesh.clients
        params, toks, _, _, _, _, _, _ = _inputs(cfg, seed=1)
        flat = toks.reshape(K * B, T)
        n_rows = K * B // cm.size
        mine = slice(cm.rank * n_rows, (cm.rank + 1) * n_rows)
        layout = MA.Layout(cfg, mesh)
        tp = layout.tp
        self.out[f'{name}.parts'] = [tp.attn, tp.mlp, tp.moe, tp.vocab,
                                     tp.ssm, layout.uses]
        fl = FLConfig(n_devices=K)
        blocks = MA.shard_params(params, layout)
        loss, grads = MA.standard_grads(blocks, cfg, {'tokens': flat[mine]},
                                        layout)
        for i, g in enumerate(grads):
            self.arrays[f'{name}.std.{i}'] = g.numpy()
        new, met = D.make_standard_train_step(cfg, fl, mesh=mesh)(
            blocks, {'tokens': flat[mine]})
        # the mean of the unsharded gradients on each client rank's rows
        parts = []
        for r in range(cm.size):
            leaves = [x.detach().requires_grad_(True)
                      for x in tree.leaves(params)]
            lr_ = tf.loss_fn(tree.unflatten(params, leaves), cfg,
                             flat[r * n_rows:(r + 1) * n_rows])
            parts.append((lr_.detach(), torch.autograd.grad(lr_, leaves)))
        ref = [true_div(sum(g[i].to(torch.float32) for _, g in parts),
                        float(cm.size)) for i in range(len(grads))]
        ref_loss = sum(float(x) for x, _ in parts) / cm.size
        whole, wm = D.make_standard_train_step(cfg, fl)(
            params, {'tokens': flat})
        err_whole = err_params = 0.0
        lr = fl.learning_rate
        for i, (a, w, p0, g) in enumerate(zip(
                tree.leaves(new), tree.leaves(whole), tree.leaves(params),
                ref)):
            # the step's new block against p - lr x the reference mean,
            # within lr x GRAD_ATOL of the leaf's largest |g| and one
            # rounding of the parameters' dtype
            upd = layout.block_of(i, (p0.to(torch.float32) - lr * g)
                                  .to(p0.dtype))
            bound = (lr * GRAD_ATOL * float(g.abs().max())
                     + float(torch.finfo(p0.dtype).eps)
                     * float(upd.abs().max()))
            err_params = max(err_params, float(
                (a.double() - upd.double()).abs().max()) / bound)
            w, p0 = layout.block_of(i, w), layout.block_of(i, p0)
            step_size = max(float((w.double() - p0.double()).abs().max()),
                            1e-30)
            err_whole = max(err_whole, float(
                (a.double() - w.double()).abs().max()) / step_size)
        self.out[f'{name}.standard'] = {
            'grads': max(_err(a, layout.block_of(i, b), b)
                         for i, (a, b) in enumerate(zip(grads, ref))),
            'params': err_params,
            'update_vs_whole': err_whole,
            'loss': abs(float(loss) - ref_loss) / abs(ref_loss),
            'step_loss': float(met['loss']) == float(loss),
            'loss_vs_whole': abs(float(met['loss']) - float(wm['loss'])),
            'expert_parallel': any(layout.on_clients)}
        try:
            D.make_fl_train_step(cfg, fl, mesh=mesh)
            self.out[f'{name}.refuses'] = not any(layout.on_clients)
        except ValueError:
            self.out[f'{name}.refuses'] = any(layout.on_clients)


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
            cases.arch(name)
        cases.reblock_bytes('mamba2-130m-reduced')
        for name in STANDARD:
            cases.standard(name)
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
    """The 4 ranks' results and gradient blocks (one spawn for the
    file)."""
    out = tmp_path_factory.mktemp('model_axis')
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


def test_ranks_lie_row_major(ranks):
    assert [tuple(r['coords'].values()) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize('arch', sorted(PARTS))
def test_tensor_parallel_partition(ranks, arch):
    """Which parts take tensor parallelism (attention mode, MLP, experts,
    vocabulary, SSM), the same on every rank; each leaf's use."""
    key = f'{arch}.parts'
    uses = {tuple(r[key][5]) for r in ranks}
    assert len(uses) == 1
    assert tuple(ranks[0][key][:5]) == PARTS[arch]
    (use,) = uses
    if PARTS[arch][0] is None and not any(PARTS[arch][1:]):
        assert set(use) == {'gather'}
    if PARTS[arch][0] == 'q':
        assert use.count('kv') == 2          # wk, wv of the one group
    if PARTS[arch][4]:
        # in_proj, conv_w, conv_b re-blocked; A_log, D, dt_bias sliced;
        # norm_scale, out_proj blocks (one Mamba2 block a group)
        assert use.count('reblock') == 3 and use.count('slice') == 3


# the partition at the production 'model' = 16: (attention, MLP, experts,
# vocabulary); granite's, mixtral's and gemma2's query heads divide,
# their 8 kv heads do not ('q': ranks 2j and 2j + 1 share kv head j)
PRODUCTION_PARTS = {
    'smollm-135m': (None, True, False, True, False),
    'granite-8b': ('q', True, False, True, False),
    'mixtral-8x7b': ('q', False, True, True, False),
    'qwen2.5-32b': (None, True, False, True, False),
    'paligemma-3b': (None, True, False, True, False),
    'gemma2-9b': ('q', True, False, True, False),
    'musicgen-medium': (None, True, False, True, False),
    'zamba2-2.7b': ('heads', True, False, True, True),
    'arctic-480b': (None, True, True, True, False),
    'mamba2-130m': (None, False, False, False, False),
}


@pytest.mark.parametrize('arch', sorted(PRODUCTION_PARTS))
def test_partition_at_production_size(arch):
    """``parallel.partition`` on (data=16, model=16) for every rank, and
    each leaf's use against ``launch.shardings``' spec (a 'block' leaf
    is split over 'model'; ``leaf_use`` raises otherwise); on one model
    rank nothing splits."""
    from types import SimpleNamespace

    from repro_torch import tree
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import shardings as sh
    from repro_torch.models import parallel
    from repro_torch.models import transformer as tf
    from repro_torch.training import model_axis as MA
    cfg = get_arch(arch)
    full = tf.init_params(cfg, torch.Generator(), device='meta')
    specs = sh.param_specs(cfg, {'data': 16, 'model': 16}, full)
    for r in range(16):
        tp = parallel.partition(cfg, SimpleNamespace(size=16, rank=r))
        assert (tp.attn, tp.mlp, tp.moe, tp.vocab,
                tp.ssm) == PRODUCTION_PARTS[arch]
        if tp.attn == 'q':
            assert tp.kv_head == r // 2
        uses = [MA.leaf_use(p, specs[p], tp) for p in tree.paths(full)]
        assert ('block' in uses) == any(PRODUCTION_PARTS[arch])
        # no Mamba2 leaf is gathered where its heads divide
        mamba = [u for p, u in zip(tree.paths(full), uses) if 'mamba' in p]
        assert ('gather' in mamba) == (bool(mamba) and not tp.ssm)
    # one model rank splits nothing: every leaf as the unsharded pass
    one = parallel.partition(cfg, SimpleNamespace(size=1, rank=0))
    assert (one.attn, one.mlp, one.moe, one.vocab, one.ssm) == (
        None, False, False, False, False)
    assert {MA.leaf_use(p, specs[p], one)
            for p in tree.paths(full)} == {'gather'}


def _tensor_parallel(arch: str) -> bool:
    return any(PARTS[arch])


@pytest.mark.parametrize('arch', ARCHS)
def test_gradient_blocks_are_the_unsharded_slices(ranks, arch):
    for r in ranks:
        res = r[f'{arch}.grads']
        assert res['sharded'] > 0
        if _tensor_parallel(arch):
            assert res['err'] <= GRAD_ATOL, res
            assert res['loss'] <= LOSS_RTOL, res
        else:
            assert res['equal'] and res['loss'] == 0.0, res


@pytest.mark.parametrize('arch', ARCHS)
def test_wire_integers_are_exact(ranks, arch):
    for r in ranks:
        assert r[f'{arch}.wire'] == {'knobs': True, 'words': True}


@pytest.mark.parametrize('wire', WIRES)
@pytest.mark.parametrize('arch', ARCHS)
def test_fl_step_equals_the_unsharded_step(ranks, arch, wire):
    for r in ranks:
        res = r[f'{arch}.{wire}']
        assert all(res['ints'].values()), res['ints']
        assert res['params'] <= PARAM_RTOL, res
        assert res['gbar'] <= PARAM_RTOL, res
        assert res['g2'] <= res['g2_bound'], res
        assert res['loss'] == 0.0, res


def test_reblock_moves_one_block_each_way(ranks):
    """Mamba2's ``in_proj``, ``conv_w`` and ``conv_b`` re-blocked: one
    all-to-all a leaf forward and one backward; a rank receives exactly
    its compute blocks forward and sends them back backward; what the
    ranks send is what they receive; a compute block is the stored block
    and at most B's and C's columns more, against the gather's ``size``
    stored blocks; a float32 copy of a bf16 layout's blocks gets float32
    gradients."""
    res = [r['mamba2-130m-reduced.reblock'] for r in ranks]
    for r in res:
        assert r['f32_copy_dtypes'] == ['torch.float32'], r
        assert r['leaves'] == 3 and r['calls'] == [3, 3], r
        assert r['fwd_received'] == r['compute'] == r['bwd_sent'], r
        assert r['bwd_received'] == r['fwd_sent'], r
        assert r['stored'] <= r['compute'] < r['gather'], r
    assert sum(r['fwd_sent'] for r in res) == sum(r['fwd_received']
                                                  for r in res)
    # one compute block a rank: the whole leaves' entries plus B's and
    # C's copies on the second model rank
    per_model = sum(r['compute'] for r in res[:2])
    assert per_model == sum(r['stored'] for r in res[:2]) + (
        res[0]['compute'] - res[0]['stored']) * 2


@pytest.mark.parametrize('arch', STANDARD)
def test_standard_step(ranks, arch):
    for r in ranks:
        res = r[f'{arch}.standard']
        assert res['expert_parallel'] == (arch != 'smollm-135m-reduced')
        assert res['grads'] <= GRAD_ATOL, res
        assert res['params'] <= 1.0, res
        assert res['loss'] <= LOSS_RTOL and res['step_loss'], res
        if not res['expert_parallel']:
            assert res['update_vs_whole'] <= WHOLE_BATCH_RTOL, res
        assert r[f'{arch}.refuses']


# -- against the reference (on pytest's side, from the ranks' blocks) -------

def _reference(arch: str, seed: int):
    """The reference's configuration and the ranks' weights and tokens as
    its arrays."""
    import jax.numpy as jnp

    from repro.configs import registry as RR
    from repro_torch import tree
    cfg = _arch(arch)
    params, toks, prefix, *_ = _inputs(cfg, seed)
    ref_params = tree.unflatten(params, [jnp.asarray(x.numpy())
                                         for x in tree.leaves(params)])
    return _arch(arch, RR), cfg, params, ref_params, toks, prefix


def _blocks_of(cfg, params, full: list, coords, lead: int) -> list:
    """Each leaf's block at ``coords`` of the (2, 2) mesh."""
    from repro_torch import tree
    from repro_torch.launch import shardings as sh
    ms = dict(zip(MESH[1], MESH[0]))
    specs = sh.param_specs(cfg, ms, params)
    out = []
    for path, x in zip(tree.paths(params), full):
        sl = sh.block_slices(specs[path], x.shape[lead:], ms, coords)
        out.append(x[(slice(None),) * lead + sl])
    return out


@pytest.mark.parametrize('arch', ARCHS)
def test_gradient_blocks_within_the_reference(spawn, arch):
    import jax

    from repro.models import transformer as RT
    ranks, arrays = spawn
    rcfg, cfg, params, ref_params, toks, prefix = _reference(arch, 0)

    def one(p, t, pre):
        return jax.value_and_grad(
            lambda pp: RT.loss_fn(pp, rcfg, t, pre))(p)

    batch = (toks.numpy(), None if prefix is None else prefix.numpy())
    losses, grads = jax.jit(jax.vmap(one, in_axes=(
        None, 0, None if prefix is None else 0)))(ref_params, *batch)
    full = [np.asarray(g) for g in jax.tree.leaves(grads)]
    for r, arr in zip(ranks, arrays):
        rows = slice(2 * r['coords']['data'], 2 * r['coords']['data'] + 2)
        want = _blocks_of(cfg, params, [g[rows] for g in full],
                          r['coords'], 1)
        for i, w in enumerate(want):
            got = arr[f'{arch}.fl.{i}']
            atol = GRAD_ATOL * float(np.abs(full[i][rows]).max())
            np.testing.assert_allclose(got, w, rtol=0, atol=atol)


@pytest.mark.parametrize('arch', STANDARD)
def test_standard_gradient_within_the_reference(spawn, arch):
    import jax

    from repro.models import transformer as RT
    ranks, arrays = spawn
    rcfg, cfg, params, ref_params, toks, _ = _reference(arch, 1)
    flat = toks.numpy().reshape(K * B, T)
    grad = jax.jit(jax.grad(lambda pp, t: RT.loss_fn(pp, rcfg, t)))
    half = K * B // 2
    parts = [jax.tree.leaves(grad(ref_params, flat[i * half:(i + 1) * half]))
             for i in range(2)]
    full = [(np.asarray(a, np.float64) + np.asarray(b, np.float64)) / 2
            for a, b in zip(*parts)]
    for r, arr in zip(ranks, arrays):
        want = _blocks_of(cfg, params, full, r['coords'], 0)
        for i, w in enumerate(want):
            got = arr[f'{arch}.std.{i}']
            atol = GRAD_ATOL * float(np.abs(full[i]).max())
            np.testing.assert_allclose(got, w, rtol=0, atol=atol)


if __name__ == '__main__':
    if sys.argv[1] == '--worker':
        worker_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
