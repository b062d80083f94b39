"""The 'model' axis of a production mesh in the LLM-scale steps
(``launch.mesh.ProductionMesh``; the layouts of ``launch.shardings``).

What a rank holds: its blocks of the parameters, of its clients'
per-client gradients and of ḡ, at the layout ``param_specs`` gives
(every 'model' entry splits a dimension over the model ranks; arctic's
expert stacks also split over the client axes).

The compute partition is tensor parallelism (``models.parallel``) where
the rank's blocks allow it, and gather at use elsewhere.  :class:`Layout`
names each leaf's use in the forward (``Layout.uses``):

* 'block': the rank's block itself, a column or row block of a
  tensor-parallel layer (the attention heads, the MLP's and the experts'
  f, the vocab rows or columns); its per-client gradient is the rank's
  block directly.  Where the spec also splits it over client axes
  (arctic's experts), those are gathered at use;
* 'kv': ``wk/wv`` (``bk/bv``) of an attention whose query heads divide
  and kv heads do not: gathered at use, the rank's one kv head taken in
  float32, the cotangent summed over the model ranks in float32 (each
  saw its query heads' share) and rounded once before the rank keeps
  its slice;
* 'slice': Mamba2's per-head ``A_log``, ``D`` and ``dt_bias`` (replicated
  over 'model') under a split SSM, and its ``in_proj``/``conv_w``/
  ``conv_b`` where their spec does not split them: the rank's heads'
  entries taken in float32, the cotangent summed over the model ranks
  in float32 and rounded once;
* 'reblock': Mamba2's ``in_proj``, ``conv_w`` and ``conv_b`` under a split
  SSM.  The reference's spec cuts contiguous columns of ``z | x | B | C
  | dt`` (and channels of ``x | B | C``), so the block a rank stores is
  not its heads' columns; :class:`ReBlock` moves each rank's stored
  block to its compute block (``parallel.ssm_columns``,
  ``parallel.conv_channels``) with one all-to-all over the model ranks,
  about one block of bytes a rank against the gather's ``size`` blocks,
  and its backward moves the cotangent back the same way (B's and C's
  columns, which every rank computes with, summed in float32 and rounded
  once).  The stored layout and the leaf's coordinate order stay the
  reference's: the packed wire packs the flattened leaf, and the
  per-client stats and the transport see the stored blocks;
* 'gather': gathered at use by :class:`GatherAtUse` (a Mamba2 block whose
  heads do not divide, an attention whose query heads do not divide, a
  vocabulary or FFN that does not divide): its backward keeps the rank's
  slice along 'model' (every model rank computed that layer whole on the
  same data) and reduce-scatters along client axes (the standard step's
  ranks saw different rows).

Under ``torch.func.vmap`` over a rank's clients a gathered leaf holds
the K_local x gradient stack at the size of a block; gathering before
the vmap would hold K_local x the whole tree.  A leaf replicated over
'model' (a norm, the router) gets the same gradient on every model rank:
the cotangent entering a parallel layer is summed over the ranks.  A
split product is taken in float32 and rounds once after the sum over
the ranks (``models.parallel``), so a tensor-parallel step differs from
the unsharded step by the order of its float32 sums, not bit for bit; a
model that takes no tensor parallelism (mamba2-130m at 16 model ranks,
or any model on one model rank) is the unsharded step bit for bit.

Serving (:class:`Serving`, ``transformer.AtUse``): prefill and decode
take each leaf by the same use, one group of layers at a time, and the
cache at ``launch.shardings.serving_cache_blocks``' layout.

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
from repro_torch.configs.base import FLConfig, ModelConfig, ShapeConfig
from repro_torch.core import transport as tr
from repro_torch.core.mesh import ClientMesh, pad_rows
from repro_torch.core.quantize import true_div
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import MODEL, ProductionMesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import parallel
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


def _gather_at_use(block: Tensor, spec, mesh) -> Tensor:
    """``block`` through :class:`GatherAtUse` (an unsharded one as is)."""
    return GatherAtUse.apply(block, mesh, spec) if _sharded_dims(spec) \
        else block


def _off_model(spec) -> tuple:
    """``spec`` with the 'model' axis taken out of every entry."""
    out = []
    for e in spec:
        axes = tuple(a for a in sh.entry_axes(e) if a != MODEL)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return tuple(out)


_ATTN_BLOCK = ('wq', 'wo', 'bq')
_FFN = ('w_gate', 'w_up', 'w_down')
_SSM_COLUMNS = ('in_proj', 'conv_w', 'conv_b')
_SSM_HEADS = ('A_log', 'D', 'dt_bias')


def _on_model(spec) -> bool:
    return any(MODEL in sh.entry_axes(e) for e in spec)


def leaf_use(path: str, spec, tp: parallel.TensorParallel) -> str:
    """How the forward takes leaf ``path`` (its spec ``spec``) under the
    partition ``tp``: 'block', 'kv', 'slice', 'reblock' or 'gather' (the
    module docstring)."""
    names = path.split('.')
    name = names[-1]
    if 'mamba' in names:
        if not tp.ssm:
            use = 'gather'
        elif name in _SSM_COLUMNS:
            use = 'reblock' if _on_model(spec) else 'slice'
        else:
            use = 'slice' if name in _SSM_HEADS else 'block'
    elif tp.attn and 'attn' in names:
        use = 'block' if tp.attn == 'heads' or name in _ATTN_BLOCK else 'kv'
    elif name in _FFN and 'moe' in names and 'dense' not in names:
        use = 'block' if tp.moe else 'gather'
    elif name in _FFN:
        use = 'block' if tp.mlp else 'gather'
    elif name in ('embed', 'lm_head'):
        use = 'block' if tp.vocab else 'gather'
    else:
        use = 'gather'
    if use == 'block' and not _on_model(spec):
        raise ValueError(f'{path}: tensor parallel, but its spec {spec} '
                         "does not split it over 'model'")
    return use


def runs(index: Sequence[int]) -> list:
    """``index`` as runs of consecutive entries, [(start, stop), ...]."""
    out = []
    for c in index:
        if out and out[-1][1] == c:
            out[-1][1] = c + 1
        else:
            out.append([c, c + 1])
    return [tuple(r) for r in out]


def run_index(rs: Sequence[tuple], device) -> Tensor:
    """The int64 index tensor of the runs ``rs`` (made from ``arange``s:
    a factory, so also inside a ``torch.func`` transform)."""
    return torch.cat([torch.arange(a, b, dtype=torch.int64, device=device)
                      for a, b in rs])


class ReBlock:
    """The all-to-all over the model ranks ``mm`` that moves each rank's
    stored block of a leaf (the reference's: ``n`` contiguous entries of
    its last dimension) to its compute block (``index[r]``, rank r's
    entries of the last dimension, ascending).  Rank r sends rank j the
    entries of ``index[j]`` it stores, in order; what rank j receives,
    in rank order, is ``index[j]`` in order.  The backward sends each
    cotangent entry back to the rank that stores it, which sums what it
    gets (an entry in several ranks' compute blocks: B's and C's) in
    float32 and rounds once to the stored block's dtype."""

    def __init__(self, mm: ClientMesh, n: int, index: Sequence[Sequence[int]]):
        r = mm.rank
        lo, hi = r * n, (r + 1) * n
        self.mm, self.n = mm, n
        self.send = runs([c - lo for ix in index for c in ix
                          if lo <= c < hi])
        self.send_counts = [sum(lo <= c < hi for c in ix) for ix in index]
        self.recv_counts = [sum(j * n <= c < (j + 1) * n for c in index[r])
                            for j in range(mm.size)]

    def _index(self, device) -> Tensor:
        return run_index(self.send, device)

    def forward(self, x: Tensor) -> Tensor:
        """(..., n) stored -> (..., compute) in float32."""
        rows = x.movedim(-1, 0).index_select(0, self._index(x.device))
        out = self.mm.all_to_all(rows, self.recv_counts, self.send_counts)
        return out.movedim(0, -1).to(torch.float32)

    def backward(self, g: Tensor, dtype: torch.dtype) -> Tensor:
        """(..., compute) float32 cotangent -> (..., n) in ``dtype``."""
        rows = g.to(torch.float32).movedim(-1, 0).contiguous()
        back = self.mm.all_to_all(rows, self.send_counts, self.recv_counts)
        out = torch.zeros((self.n,) + tuple(back.shape[1:]),
                          dtype=torch.float32, device=g.device)
        out = out.index_add(0, self._index(g.device), back)
        return out.movedim(0, -1).to(dtype)


class _ReBlock(torch.autograd.Function):
    """The stored block -> the compute block (:class:`ReBlock`); its
    backward :class:`_ReBlockBack`.  Explicit ``vmap`` rules hand the
    all-to-all the whole batched tensor."""

    @staticmethod
    def forward(x, plan):
        return plan.forward(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan, ctx.dtype = inputs[1], inputs[0].dtype

    @staticmethod
    def backward(ctx, g):
        return _ReBlockBack.apply(g, ctx.plan, ctx.dtype), None

    @staticmethod
    def vmap(info, in_dims, x, plan):
        if in_dims[0] is None:
            return _ReBlock.apply(x, plan), None
        return _ReBlock.apply(x.movedim(in_dims[0], 0), plan), 0


class _ReBlockBack(torch.autograd.Function):
    """A compute block's cotangent -> the stored block's."""

    @staticmethod
    def forward(g, plan, dtype):
        return plan.backward(g, dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError('the re-block use is differentiable once')

    @staticmethod
    def vmap(info, in_dims, g, plan, dtype):
        if in_dims[0] is None:
            return _ReBlockBack.apply(g, plan, dtype), None
        return _ReBlockBack.apply(g.movedim(in_dims[0], 0), plan, dtype), 0


def compute_index(path: str, cfg: ModelConfig, rank: int, size: int
                  ) -> list:
    """Model rank ``rank``'s entries of the last dimension of a Mamba2
    leaf under a split SSM (its 'slice' or 'reblock' use)."""
    name = path.split('.')[-1]
    if name == 'in_proj':
        return parallel.ssm_columns(cfg, rank, size)
    if name in ('conv_w', 'conv_b'):
        return parallel.conv_channels(cfg, rank, size)
    heads = parallel.ssm_heads(cfg, rank, size)
    return list(range(heads.start, heads.stop))


class Layout:
    """The parameter layout of ``cfg`` on ``mesh``: paths, full shapes,
    specs and the rank's block slices, from the shapes alone (the
    parameters made on the meta device); the tensor-parallel partition
    ``tp`` and each leaf's use."""

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
        self.tp = parallel.partition(cfg, mesh.axis_mesh(MODEL))
        self.uses = [leaf_use(p, s, self.tp)
                     for p, s in zip(self.paths, self.specs)]
        self.head_dim = cfg.resolved_head_dim
        m = self.tp.size
        self.index = {i: compute_index(p, cfg, self.tp.rank, m)
                      for i, (p, u) in enumerate(zip(self.paths, self.uses))
                      if u in ('slice', 'reblock')}
        self.reblock = {
            i: ReBlock(self.tp.mesh, self.shapes[i][-1] // m,
                       [compute_index(self.paths[i], cfg, r, m)
                        for r in range(m)])
            for i, u in enumerate(self.uses) if u == 'reblock'}
        self._at = {p: i for i, p in enumerate(self.paths)}

    def use_leaf(self, i: int, b: Tensor, spec=None) -> Tensor:
        """What the forward computes with from leaf i's block ``b``, by
        its use (``spec``: the block's spec, default leaf i's; a group's
        leaf without its group axis drops the first entry)."""
        spec = self.specs[i] if spec is None else spec
        use = self.uses[i]
        if use == 'block':
            return _gather_at_use(b, _off_model(spec), self.mesh)
        if use == 'reblock':
            return _ReBlock.apply(b, self.reblock[i])
        full = _gather_at_use(b, spec, self.mesh)
        if use == 'gather':
            return full
        full = parallel.copy_to(full.to(torch.float32), self.tp)
        if use == 'kv':
            hd, k = self.head_dim, self.tp.kv_head
            return full[..., k * hd:(k + 1) * hd]
        return torch.cat([full.narrow(-1, a, b - a)
                          for a, b in runs(self.index[i])], dim=-1)

    def used(self, blocks: Sequence[Tensor]) -> list:
        """What the forward computes with, from the rank's blocks (each
        leaf by its use)."""
        return [self.use_leaf(i, b) for i, b in enumerate(blocks)]

    def leaf(self, path: str) -> int:
        """The index of the leaf at ``path``."""
        return self._at[path]

    def block_of(self, i: int, full: Tensor, lead: int = 0) -> Tensor:
        """Leaf i's block of ``full`` (after ``lead`` leading dims)."""
        return full[(slice(None),) * lead + self.slices[i]]


class Serving(tf.AtUse):
    """A rank's prefill and decode on a production mesh
    (``transformer.AtUse``): each weight by its use
    (:meth:`Layout.use_leaf`: the rank's blocks where the partition
    splits them, else gathered at use, a group's leaves one group at a
    time), each cache leaf at ``launch.shardings.serving_cache_blocks``'
    layout for ``shape`` (the global batch and the cache's length):
    'heads' as held, 'reference' gathered over 'model' at use and cut
    back after, 'sequence' attended in place over the ranks that split
    it (a prefill's whole sequence cut to the rank's block).  ``rows``:
    the rank's rows of the global batch (``prefill_batch_spec``)."""

    def __init__(self, layout: Layout, cfg: ModelConfig, shape: ShapeConfig):
        mesh = layout.mesh
        self.layout, self.tp, self.mesh, self.cfg = layout, layout.tp, mesh, cfg
        full = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device='meta')
        self.full_shapes = {p: s[1:] for p, s in sh.shapes_of(full).items()}
        self.specs = {p: s[1:] for p, s in
                      sh.cache_specs(cfg, mesh, shape, full).items()}
        self.blocks = {p: (kind, index[1:]) for p, (kind, index) in
                       sh.serving_cache_blocks(cfg, mesh, shape, full,
                                               self.tp).items()}
        spec = sh.sanitize_spec(sh.prefill_batch_spec(cfg, mesh)['tokens'],
                                (shape.global_batch, 1), mesh)
        self.rows = sh.block_slices(spec, (shape.global_batch, 1), mesh,
                                    mesh.coords)[0]
        self.rows_split = bool(_sharded_dims(spec))

    def held_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """{path: the rank's held shape} of a group's cache leaf."""
        return {p: sh.index_shape(ix, self.full_shapes[p])
                for p, (_, ix) in self.blocks.items()}

    def params(self, path: str, x: Tensor) -> Tensor:
        i = self.layout.leaf(path)
        spec = self.layout.specs[i]
        return self.layout.use_leaf(
            i, x, spec[1:] if path.startswith('groups.') else spec)

    def cache_in(self, path: str, x: Tensor) -> Tensor:
        kind, _ = self.blocks[path]
        if kind != 'reference':
            return x
        for d, axes in _sharded_dims(self.specs[path]):
            if d and MODEL in axes:
                x = gather_dim(self.mesh, x, d, axes)
        return x

    def cache_out(self, path: str, x: Tensor) -> Tensor:
        kind, index = self.blocks[path]
        full = self.full_shapes[path]
        if (kind == 'sequence' and self.tp.attn is not None
                and x.shape[2] != full[2]):
            x = attn_mod.heads_of_all(x, self.tp, True, self.cfg)
        cut = tuple(e if x.shape[d] == n else slice(None)
                    for d, (e, n) in enumerate(zip(index, full)))
        if all(e == slice(None) for e in cut):
            return x
        # a copy: a view would keep the whole leaf alive
        return sh.take(x, cut).clone()

    def seq(self, path: str):
        kind, _ = self.blocks[path]
        if kind != 'sequence':
            return None
        return self.mesh.axis_mesh(sh.entry_axes(self.specs[path][1]))

    def gather_rows(self, x: Tensor) -> Tensor:
        """The global batch's rows from each client rank's ``rows``."""
        return self.mesh.clients.all_gather(x) if self.rows_split else x


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
    *block) leaves, ``vmap`` of ``grad_and_value`` with each leaf taken
    by its use (``Layout.used``) and the forward tensor parallel
    (``layout.tp``)."""
    from repro_torch.training.distributed import deterministic_algorithms
    leaves = [b.detach() for b in tree.leaves(params)]

    def loss(ls, toks, pre):
        used = tree.unflatten(params, layout.used(ls))
        return tf.loss_fn(used, cfg, toks, pre, tp=layout.tp)

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


def standard_grads(params, cfg: ModelConfig, batch: Dict[str, Tensor],
                   layout: Layout) -> Tuple[Tensor, list]:
    """The standard step's loss and gradient blocks from the parameter
    blocks ``params`` on this rank's rows ``batch``: the mean of the
    client ranks' mean losses (equal rows a rank) and, each leaf in
    float32, the sum over the client ranks (a reduce-scatter inside
    :class:`GatherAtUse` where its spec splits over client axes, an
    all-reduce after the pass otherwise) over their count."""
    cm = layout.mesh.clients
    n_c = cm.size
    blocks = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    used = tree.unflatten(params, layout.used(blocks))
    loss = tf.loss_fn(used, cfg, batch['tokens'], batch.get('prefix'),
                      tp=layout.tp)
    out = []
    for g, on_c in zip(torch.autograd.grad(loss, blocks), layout.on_clients):
        g = g.to(torch.float32)
        if not on_c:
            g = cm.all_reduce(g.clone())
        out.append(true_div(g, float(n_c)))
    loss = true_div(cm.all_reduce(loss.detach().clone()), float(n_c))
    return loss, out


def make_standard_train_step(cfg: ModelConfig, fl: FLConfig,
                             mesh: ProductionMesh):
    """``training.distributed.make_standard_train_step`` on a production
    mesh: ``train_step(param_blocks, batch) -> (new param blocks,
    {'loss', 'g_norm_sq'})``, ``batch`` this rank's rows of the global
    (B, T) batch (rows split over the client axes), the gradient
    :func:`standard_grads`'."""
    layout = Layout(cfg, mesh)
    lr = fl.learning_rate

    def train_step(params, batch):
        loss, grads = standard_grads(params, cfg, batch, layout)
        out, g2 = [], torch.zeros((), dtype=torch.float32,
                                  device=loss.device)
        for p, g, c in zip(tree.leaves(params), grads,
                           layout.counted_once):
            out.append((p.detach().to(torch.float32) - lr * g).to(p.dtype))
            if c:
                g2 = g2 + torch.sum(torch.square(g))
        g2 = mesh.axis_mesh(mesh.axes).all_reduce(g2)
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
