"""The 'model' axis of a production mesh in the LLM-scale steps
(``launch.mesh.ProductionMesh``; the layouts of ``launch.shardings``).

What a rank holds: its blocks of the parameters, of its clients'
per-client gradients and of ḡ, at the layout ``param_specs`` gives
(every 'model' entry splits a dimension over the model ranks; arctic's
expert stacks also split over the client axes).

The compute partition is gather at use: a sharded weight is all-gathered
over the axes its spec names inside the differentiated function, by
:class:`GatherAtUse`, so the forward is the unsharded forward on the same
weights.  Its backward keeps the rank's slice along 'model' (every model
rank saw the same data) and reduce-scatters along client axes (the
standard step's ranks saw different rows).  Under ``torch.func.vmap``
over a rank's clients this holds the K_local x gradient stack at the
size of a block; gathering before the vmap would hold K_local x the
whole tree.  A rank's per-client gradient block is then the same slice
of the unsharded pass's gradients, bit for bit.  Megatron-style
activation partitioning (column and row parallel layers, vocab-parallel
cross-entropy) is not here: every model rank runs the whole forward of
its clients.

The per-client stats (||g_k||^2, min |g|, max |g|) of a rank's blocks
are all-reduced over 'model' (sum, min, max; a block replicated over
'model' counts once), then gathered over the client axes.  The tree
transport runs on the rank's block of each leaf on the analytic wire
(every coordinate's math is its own); on the packed wire each leaf and
ḡ are all-gathered over 'model' first (words pack 32 coordinates of the
flattened leaf) and the rank keeps its block of ĝ, as the reference's
sharded kernels cover the client axes only.  ``fl.collective`` 'sharded'
runs the transport on ``mesh.clients`` (packed wire); 'gather' first
all-gathers the gradient rows over the client axes.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.func import grad_and_value, vmap
from torch.profiler import record_function

from repro_torch import tree
from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core import transport as tr
from repro_torch.core.mesh import ClientMesh, pad_rows
from repro_torch.core.quantize import true_div
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import MODEL, ProductionMesh
from repro_torch.models import transformer as tf

Tensor = torch.Tensor


def _sharded_dims(spec) -> list:
    """(dimension, axes) of each sharded dimension of ``spec``."""
    return [(d, sh.entry_axes(e)) for d, e in enumerate(spec)
            if sh.entry_axes(e)]


def gather_dim(mesh: ProductionMesh, t: Tensor, dim: int, axes) -> Tensor:
    """Every rank's block of ``t`` along ``axes`` concatenated along
    ``dim`` in their row-major order (contiguous)."""
    x = t.movedim(dim, 0).contiguous()
    return mesh.axis_mesh(axes).all_gather(x).movedim(0, dim).contiguous()


def gather_full(mesh: ProductionMesh, t: Tensor, spec, lead: int = 0
                ) -> Tensor:
    """The full leaf from a rank's block ``t`` (``lead`` leading
    dimensions before the spec's, e.g. the client axis)."""
    for d, axes in _sharded_dims(spec):
        t = gather_dim(mesh, t, lead + d, axes)
    return t


def _reduce_scatter_dim(mesh: ProductionMesh, t: Tensor, dim: int, axes
                        ) -> Tensor:
    """The sum of ``t`` over the ranks along ``axes``, this rank's block
    along ``dim``."""
    cm = mesh.axis_mesh(axes)
    x = t.movedim(dim, 0).contiguous()
    n = x.shape[0] // cm.size
    if cm.backend == 'gloo' or cm.group is None:
        s = cm.all_reduce(x.clone())
        out = s[cm.rank * n:(cm.rank + 1) * n]
    else:
        out = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        torch.distributed.reduce_scatter_tensor(out, x, group=cm.group)
    return out.movedim(0, dim)


class GatherAtUse(torch.autograd.Function):
    """block -> the full weight (all-gathers over the spec's axes);
    backward: the rank's slice along 'model', a reduce-scatter along
    client axes."""

    generate_vmap_rule = True

    @staticmethod
    def forward(block, mesh, spec):
        return gather_full(mesh, block, spec)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, ctx.spec = inputs
        ctx.block_shape = tuple(inputs[0].shape)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        for d, axes in reversed(_sharded_dims(ctx.spec)):
            if MODEL in axes and len(axes) > 1:
                raise ValueError(f'a weight split over {axes}: the model '
                                 'axis and client axes in one dimension')
            if axes == (MODEL,):
                n = ctx.block_shape[d]
                grad = grad.narrow(d, mesh.index(axes) * n, n)
            else:
                grad = _reduce_scatter_dim(mesh, grad, d, axes)
        return grad, None, None


def gathered(blocks: Sequence[Tensor], specs: Sequence, mesh) -> list:
    """Each block through :class:`GatherAtUse` (an unsharded one as is)."""
    return [GatherAtUse.apply(b, mesh, s) if _sharded_dims(s) else b
            for b, s in zip(blocks, specs)]


class Layout:
    """The parameter layout of ``cfg`` on ``mesh``: paths, full shapes,
    specs and the rank's block slices, from the shapes alone (the
    parameters made on the meta device)."""

    def __init__(self, cfg: ModelConfig, mesh: ProductionMesh):
        full = tf.init_params(cfg, torch.Generator(), device='meta')
        self.mesh = mesh
        self.paths = tree.paths(full)
        self.shapes = [tuple(x.shape) for x in tree.leaves(full)]
        self.dtypes = [x.dtype for x in tree.leaves(full)]
        spec_of = sh.param_specs(cfg, mesh, full)
        self.specs = [spec_of[p] for p in self.paths]
        self.slices = [sh.block_slices(s, shape, mesh, mesh.coords)
                       for s, shape in zip(self.specs, self.shapes)]
        axes = [set(sum((sh.entry_axes(e) for e in s), ()))
                for s in self.specs]
        # a block counts once in a sum over 'model' (replicated: rank 0)
        self.counted = [MODEL in a or mesh.coords[MODEL] == 0 for a in axes]
        # split over client axes (expert parallelism)
        self.on_clients = [bool(a & set(mesh.client_axes)) for a in axes]
        # a block counts once in a mesh-wide sum: the rank whose
        # coordinates off the spec's axes are all 0
        self.counted_once = [all(mesh.coords[x] == 0 for x in mesh.axes
                                 if x not in a) for a in axes]
        self.dim = sum(torch.Size(s).numel() for s in self.shapes)

    def block_of(self, i: int, full: Tensor, lead: int = 0) -> Tensor:
        """Leaf i's block of ``full`` (after ``lead`` leading dims)."""
        return full[(slice(None),) * lead + self.slices[i]]


class BlockDraws(Sequence):
    """The rank's block of each leaf's (K, n_i) quantizer uniforms: the
    whole draw is taken (the gathered draw's bits), the block kept."""

    def __init__(self, rand: Sequence[Tensor], layout: Layout):
        self.rand, self.layout = rand, layout

    def __len__(self) -> int:
        return len(self.rand)

    def __getitem__(self, i: int) -> Tensor:
        r = self.rand[i]
        full = r.reshape((r.shape[0],) + self.layout.shapes[i])
        return self.layout.block_of(i, full, 1).reshape(r.shape[0], -1)


def client_grads(params, cfg: ModelConfig, tokens: Tensor, layout: Layout,
                 deterministic: bool = False,
                 prefix: Optional[Tensor] = None) -> Tuple[Tensor, list]:
    """Each of the rank's clients' loss and gradient blocks from the
    parameter blocks ``params``: (K_local,) f32 losses and (K_local,
    *block) leaves, ``vmap`` of ``grad_and_value`` with every sharded
    weight gathered at use."""
    from repro_torch.training.distributed import deterministic_algorithms
    leaves = [b.detach() for b in tree.leaves(params)]
    mesh, specs = layout.mesh, layout.specs

    def loss(ls, toks, pre):
        full = tree.unflatten(params, gathered(ls, specs, mesh))
        return tf.loss_fn(full, cfg, toks, pre)

    with deterministic_algorithms(deterministic):
        grads, losses = vmap(grad_and_value(loss),
                             in_dims=(None, 0, None if prefix is None
                                      else 0))(leaves, tokens, prefix)
    return losses, list(grads)


def model_stats(grads: Sequence[Tensor], layout: Layout) -> dict:
    """The rank's clients' tree stats over the whole tree: the blocks'
    stats all-reduced over 'model' (sum, min, max), ``dim`` the full
    tree's."""
    k = grads[0].shape[0]
    mine = [g for g, c in zip(grads, layout.counted) if c]
    if mine:
        st = tr.tree_client_stats(mine)
    else:
        f32 = dict(dtype=torch.float32, device=grads[0].device)
        st = {'g2': torch.zeros((k,), **f32),
              'g_min': torch.full((k,), float('inf'), **f32),
              'g_max': torch.zeros((k,), **f32)}
    rd = torch.distributed.ReduceOp
    mm = layout.mesh.axis_mesh(MODEL)
    return {'g2': mm.all_reduce(st['g2'], rd.SUM),
            'g_min': mm.all_reduce(st['g_min'], rd.MIN),
            'g_max': mm.all_reduce(st['g_max'], rd.MAX),
            'dim': layout.dim}


def g2_rtol(n_leaves: int) -> float:
    """How far ||g_k||^2 of :func:`model_stats` may be from the unsharded
    sum, relative: float32 eps for each rounding that may differ, two a
    leaf (its blocks' sums, and its share of the all-reduce) and two
    more."""
    return (2 * n_leaves + 2) * float(torch.finfo(torch.float32).eps)


def _client_rows(cm: ClientMesh, leaves: Sequence[Tensor], k: int) -> list:
    """The K clients' rows of each leaf from every rank's rows (one
    all_gather a leaf over the client axes)."""
    if cm.size == 1:
        return list(leaves)
    return [cm.gather_rows(pad_rows(x, cm.k_local(k)), k) for x in leaves]


def make_fl_train_step(cfg: ModelConfig, fl: FLConfig, transport_kind: str,
                       mesh: ProductionMesh, deterministic: bool = False):
    """``training.distributed.make_fl_train_step`` on a production mesh:
    ``train_step(param_blocks, batch, gbar_blocks, q, p, draws,
    active_u=None) -> (new param blocks, new ḡ blocks, metrics)``;
    ``batch`` holds this rank's client rows (``mesh.clients.rows(K)``),
    the metrics are the K clients' on every rank."""
    from repro_torch.training import distributed as dist
    layout = Layout(cfg, mesh)
    split = [p for p, on_c in zip(layout.paths, layout.on_clients) if on_c]
    if split:
        raise ValueError(
            f'{cfg.name} on {mesh.shape}: {split} split over the client axes '
            '(expert parallelism), so per-client gradients do not exist; '
            'take make_standard_train_step')
    cm = mesh.clients
    lr = fl.learning_rate
    adversary = dist._adversary_closures(fl)
    packed = fl.wire == 'packed'

    def train_step(params, batch, gbar, q, p, draws: tr.TreeDraws,
                   active_u: Optional[Tensor] = None):
        k = q.shape[0]
        dist._check_block(cm, k, batch['tokens'].shape[0])
        with record_function('step/gradients'):
            losses, grads = client_grads(params, cfg, batch['tokens'],
                                         layout, deterministic,
                                         prefix=batch.get('prefix'))
        with record_function('step/stats'):
            stats = model_stats(grads, layout)
            losses, stats, _ = dist._gather_report(cm, k, losses, stats)
        gb = tree.leaves(gbar)
        rand = draws.rand
        if packed:       # whole leaves: words pack the flattened leaf
            grads = [gather_full(mesh, g, s, lead=1)
                     for g, s in zip(grads, layout.specs)]
            gb = [gather_full(mesh, b, s) for b, s in zip(gb, layout.specs)]
        else:
            rand = BlockDraws(rand, layout)
        if fl.collective != 'sharded':
            grads = _client_rows(cm, grads, k)
        ghat, stats, diag = dist.tree_transport(
            transport_kind, grads, gb, q, p, fl, draws._replace(rand=rand),
            stats, cm, adversary, active_u)
        del grads
        ghat = [layout.block_of(i, g) if packed else g
                for i, g in enumerate(ghat)]
        with record_function('step/update'):
            new_params = tree.unflatten(params, [
                (pp.to(torch.float32) - lr * g).to(pp.dtype)
                for pp, g in zip(tree.leaves(params), ghat)])
            new_gbar = tree.unflatten(params, [torch.abs(g) for g in ghat])
        return new_params, new_gbar, dist.step_metrics(losses, stats, diag,
                                                       q, p)

    return train_step


def make_standard_train_step(cfg: ModelConfig, fl: FLConfig,
                             mesh: ProductionMesh):
    """``training.distributed.make_standard_train_step`` on a production
    mesh: ``train_step(param_blocks, batch) -> (new param blocks,
    {'loss', 'g_norm_sq'})``, ``batch`` this rank's rows of the global
    (B, T) batch (rows split over the client axes).  The global loss is
    the mean of the client ranks' means (equal rows a rank); a gradient
    block is the sum over the client ranks (a reduce-scatter inside
    :class:`GatherAtUse` where its spec splits over client axes, an
    all-reduce after the pass otherwise) over their count."""
    layout = Layout(cfg, mesh)
    cm = mesh.clients
    lr = fl.learning_rate
    n_c = cm.size

    def train_step(params, batch):
        blocks = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        full = tree.unflatten(params, gathered(blocks, layout.specs, mesh))
        loss = tf.loss_fn(full, cfg, batch['tokens'], batch.get('prefix'))
        grads = torch.autograd.grad(loss, blocks)
        out, g2 = [], torch.zeros((), dtype=torch.float32,
                                  device=loss.device)
        for p, g, on_c, c in zip(blocks, grads, layout.on_clients,
                                 layout.counted_once):
            g = g.to(torch.float32)
            if not on_c:
                g = cm.all_reduce(g.clone())
            g = true_div(g, float(n_c))
            out.append((p.detach().to(torch.float32) - lr * g).to(p.dtype))
            if c:
                g2 = g2 + torch.sum(torch.square(g))
        world = mesh.axis_mesh(mesh.axes)
        g2 = world.all_reduce(g2)
        loss = true_div(cm.all_reduce(loss.detach().clone()), float(n_c))
        return tree.unflatten(params, out), {'loss': loss, 'g_norm_sq': g2}

    return train_step


def shard_params(params, layout: Layout):
    """The rank's blocks of a full parameter tree."""
    return tree.unflatten(params, [
        layout.block_of(i, x) for i, x in enumerate(tree.leaves(params))])


def rank_bytes(layout: Layout, k_local: int, whole: bool = False
               ) -> Dict[str, int]:
    """Bytes a rank holds at rest: its parameter blocks, its clients'
    per-client gradient blocks (K_local x a block, the parameters'
    dtypes) and ḡ's blocks (float32), from ``launch.shardings``' block
    shapes (``whole``: the unsharded step's, every leaf whole)."""
    mesh = layout.mesh
    blocks = [shape if whole else sh.block_shape(s, shape, mesh)
              for s, shape in zip(layout.specs, layout.shapes)]
    params = sum(torch.Size(b).numel() * d.itemsize
                 for b, d in zip(blocks, layout.dtypes))
    gbar = sum(torch.Size(b).numel() * 4 for b in blocks)
    return {'params': params, 'grads': k_local * params, 'gbar': gbar}
