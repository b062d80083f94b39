"""Sharding rules: parameter, batch, cache and per-client-gradient layouts
for every (architecture x input shape) on the production meshes (the
port of ``repro.launch.shardings``, whose rules these are).

Conventions:

* 'model' — tensor parallelism inside a client: attention heads, FFN
  hidden, vocab rows;
* 'data' — the FL client axis ('pod' before it on the multi-pod mesh):
  the leading K axis of batches and per-client gradients;
* arctic-480b also spreads its expert axis over the client axes (expert
  parallelism), which is why its per-client gradients cannot exist;
* long_500k shards KV caches along the sequence over ('data', 'model').

Here the rules are plain functions of (leaf path names, shape, mesh
shape).  A spec is a tuple with one entry a dimension: ``None``
(replicated), an axis name, or a tuple of axis names (the dimension
split row-major over them); a tree's specs are a dict from the dotted
path of each leaf (``repro_torch.tree.paths``) to its spec.  A mesh is a
``launch.mesh.ProductionMesh`` or a mapping {axis: size} in mesh order.
:func:`shard` cuts a full tree into one rank's blocks and
:func:`unshard` puts every rank's blocks back together.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import MODEL, coords_of, mesh_shape
from repro_torch.models import parallel

Spec = Tuple[Any, ...]

# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------


def _client_axes(shape: Dict[str, int]) -> Tuple[str, ...]:
    return tuple(a for a in shape if a != MODEL)


def _lead(shape: Dict[str, int]):
    """The client axes as one spec entry (a name where there is one)."""
    ca = _client_axes(shape)
    return ca if len(ca) > 1 else ca[0]


def entry_axes(entry) -> Tuple[str, ...]:
    """The axes one spec entry names (none for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry_extent(shape: Dict[str, int], entry) -> int:
    """Ranks along the axes one spec entry names."""
    return math.prod(shape[a] for a in entry_axes(entry))


# ---------------------------------------------------------------------------
# parameter shardings
# ---------------------------------------------------------------------------

def _param_spec(names: Sequence[str], leaf_shape, cfg: ModelConfig,
                expert_axes, shape: Dict[str, int]) -> Spec:
    name = names[-1]
    grouped = names[0] == 'groups'          # leading (n_groups,) axis
    ndim = len(leaf_shape)

    def g(*spec):
        return (None,) + spec if grouped else spec

    if name == 'embed':
        # vocab-sharded when divisible (mamba2's 50280 is not: shard d)
        if leaf_shape[0] % shape[MODEL] == 0:
            return (MODEL, None)
        return (None, MODEL)
    if name == 'lm_head':
        return (None, MODEL)
    if name in ('final_norm', 'frontend_proj'):
        return ()
    # attention
    if name in ('wq', 'wk', 'wv'):
        return g(None, MODEL)
    if name == 'wo':
        return g(MODEL, None)
    if name in ('bq', 'bk', 'bv'):
        return g(MODEL)
    # dense mlp
    if name in ('w_gate', 'w_up', 'w_down'):
        if ndim - (1 if grouped else 0) == 3:    # MoE expert stacks (E, d, f)
            if name == 'w_down':
                return g(expert_axes, MODEL, None)
            return g(expert_axes, None, MODEL)
        if name == 'w_down':
            return g(MODEL, None)
        return g(None, MODEL)
    if name == 'router':
        return g(None, None)
    # mamba
    if name == 'in_proj':
        return g(None, MODEL)
    if name == 'out_proj':
        return g(MODEL, None)
    if name == 'conv_w':
        return g(None, MODEL)
    if name in ('conv_b', 'norm_scale'):
        return g(MODEL)
    if name in ('A_log', 'D', 'dt_bias'):
        return g(None)
    # norms and anything residual-dim shaped
    return g(*([None] * (ndim - (1 if grouped else 0))))


def sanitize_spec(spec: Spec, leaf_shape, mesh) -> Spec:
    """``spec`` padded with ``None`` to the leaf's rank, with the sharding
    dropped on any dimension its axes do not divide (smollm's 3 kv heads
    or mamba2's vocab of 50280 cannot split over model=16)."""
    shape = mesh_shape(mesh)
    entries = list(spec) + [None] * (len(leaf_shape) - len(spec))
    return tuple(None if e is None or dim % entry_extent(shape, e) else e
                 for dim, e in zip(leaf_shape, entries))


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, 'shape') else tuple(leaf)


def param_specs(cfg: ModelConfig, mesh, params) -> Dict[str, Spec]:
    """{path: spec} of the parameter tree ``params`` (tensors, meta
    tensors included, or shapes)."""
    shape = mesh_shape(mesh)
    # arctic's experts spread over the client axes (EP); others replicate E
    expert_axes = None
    if cfg.is_moe and cfg.n_experts > shape[MODEL]:
        expert_axes = _lead(shape)
    out = {}
    for path, leaf in zip(tree.paths(params), tree.leaves(params)):
        s = _shape_of(leaf)
        out[path] = sanitize_spec(
            _param_spec(path.split('.'), s, cfg, expert_axes, shape), s,
            shape)
    return out


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------

def train_batch_specs(cfg: ModelConfig, mesh, per_client: bool
                      ) -> Dict[str, Spec]:
    lead = _lead(mesh_shape(mesh))
    spec = {'tokens': (lead, None, None) if per_client else (lead, None)}
    if cfg.frontend == 'vision' and cfg.n_prefix_tokens:
        spec['prefix'] = ((lead, None, None, None) if per_client
                          else (lead, None, None))
    return spec


def prefill_batch_spec(cfg: ModelConfig, mesh) -> Dict[str, Spec]:
    lead = _lead(mesh_shape(mesh))
    spec = {'tokens': (lead, None)}
    if cfg.frontend == 'vision' and cfg.n_prefix_tokens:
        spec['prefix'] = (lead, None, None)
    return spec


def _cache_leaf_spec(names: Sequence[str], ndim: int, cfg: ModelConfig,
                     shape: Dict[str, int], seq_shard: bool) -> Spec:
    name = names[-1]
    batch_axes = _lead(shape)
    if name in ('k', 'v'):
        # (G, B, S, kv, hd): head_dim over 'model' and batch over the
        # clients, or the sequence over ('data', 'model'); layout 'batch'
        # shards the batch only (no cache gathers)
        if seq_shard:
            return (None, None, ('data', MODEL), None, None)
        if cfg.decode_cache_layout == 'batch':
            return (None, batch_axes, None, None, None)
        return (None, batch_axes, None, None, MODEL)
    if name == 'conv':
        # (G, B, W-1, conv_dim): tiny at batch 1, replicated then
        if seq_shard:
            return (None, None, None, None)
        return (None, batch_axes, None, MODEL)
    if name == 'ssm':
        # (G, B, nh, P, S): the SSM head_dim; O(1) state, replicated when
        # the batch cannot shard
        if seq_shard:
            return (None, None, None, None, None)
        return (None, batch_axes, None, MODEL, None)
    return (None,) * ndim


def cache_specs(cfg: ModelConfig, mesh, shape: ShapeConfig, cache
                ) -> Dict[str, Spec]:
    """{path: spec} of a cache tree; sequence sharding where the global
    batch is smaller than the 'data' axis (long_500k)."""
    ms = mesh_shape(mesh)
    seq_shard = shape.global_batch < ms['data']
    out = {}
    for path, leaf in zip(tree.paths(cache), tree.leaves(cache)):
        s = _shape_of(leaf)
        out[path] = sanitize_spec(
            _cache_leaf_spec(path.split('.'), len(s), cfg, ms, seq_shard),
            s, ms)
    return out


def serving_cache_blocks(cfg: ModelConfig, mesh, shape: ShapeConfig, cache,
                         tp, coords: Optional[Dict[str, int]] = None
                         ) -> Dict[str, Tuple[str, tuple]]:
    """The port's serving cache layout under the tensor-parallel partition
    ``tp`` (``models.parallel``): {path: (kind, index)}, ``index`` the
    rank's part of the leaf, one entry a dimension (a slice, or a list of
    indices: a split Mamba2 conv window's channels), ``kind`` how the
    rank computes with it:

    * 'heads': by heads where the partition splits them: K/V the rank's
      kv heads (under 'q' the one it uses: up to twice the reference's
      block, which splits ``head_dim``), the conv window its heads' x
      channels with B and C whole, the SSM state its heads; the batch as
      :func:`cache_specs` shards it.  Computed with as held;
    * 'sequence': K/V whose sequence :func:`cache_specs` splits
      (long_500k): the reference's block, attended in place;
    * 'reference': elsewhere, the reference's block, gathered at use over
      its 'model' dimensions one layer at a time.

    ``coords``: the rank's (default the mesh's own)."""
    ms = mesh_shape(mesh)
    coords = mesh.coords if coords is None else coords
    specs = cache_specs(cfg, mesh, shape, cache)
    out = {}
    for path, leaf in zip(tree.paths(cache), tree.leaves(cache)):
        s = _shape_of(leaf)
        spec = specs[path]
        ref = block_slices(spec, s, ms, coords)
        name = path.split('.')[-1]
        whole = [slice(None)] * len(s)
        whole[1] = ref[1]                          # the batch
        r, m = tp.rank, tp.size
        if name in ('k', 'v') and spec[2] is not None:
            out[path] = ('sequence', ref)
        elif name in ('k', 'v') and tp.attn is not None:
            n = cfg.n_kv_heads // m
            whole[3] = (slice(r * n, (r + 1) * n) if tp.attn == 'heads'
                        else slice(tp.kv_head, tp.kv_head + 1))
            out[path] = ('heads', tuple(whole))
        elif name in ('conv', 'ssm') and tp.ssm:
            if name == 'conv':
                whole[3] = parallel.conv_channels(cfg, r, m)
            else:
                whole[2] = parallel.ssm_heads(cfg, r, m)
            out[path] = ('heads', tuple(whole))
        else:
            out[path] = ('reference', ref)
    return out


def index_shape(index: tuple, leaf_shape) -> Tuple[int, ...]:
    """The shape of a leaf's part ``index`` (slices or index lists)."""
    return tuple(len(range(*e.indices(n))) if isinstance(e, slice)
                 else len(e) for e, n in zip(index, leaf_shape))


def take(x: torch.Tensor, index: tuple, skip: int = 0) -> torch.Tensor:
    """The part ``index`` of ``x`` (slices, then the index lists; the
    first ``skip`` entries of ``index`` left out: a group's leaf without
    its group axis)."""
    index = index[skip:]
    x = x[tuple(e if isinstance(e, slice) else slice(None) for e in index)]
    for d, e in enumerate(index):
        if not isinstance(e, slice):
            x = x.index_select(d, torch.tensor(e, dtype=torch.int64,
                                               device=x.device))
    return x


def decode_token_spec(cfg: ModelConfig, mesh, shape: ShapeConfig) -> Spec:
    ms = mesh_shape(mesh)
    if shape.global_batch < ms['data']:
        return (None, None)                  # batch too small to shard
    return (_lead(ms), None)


# ---------------------------------------------------------------------------
# uplink (per-client gradient / packed payload) shardings
# ---------------------------------------------------------------------------

def client_spec(mesh, ndim: int = 2) -> Spec:
    """Leading-K client-sharded spec for uplink arrays: stacked
    per-client gradients (K, ...), packed (K, W) words and the (K,)
    per-client scalars; the trailing dimensions stay local."""
    return (_lead(mesh_shape(mesh)),) + (None,) * (ndim - 1)


def replicated(mesh=None) -> Spec:
    return ()


# ---------------------------------------------------------------------------
# blocks of a rank
# ---------------------------------------------------------------------------

def block_slices(spec: Spec, leaf_shape, mesh,
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of a leaf of ``leaf_shape`` that the rank at ``coords``
    holds under ``spec`` (a dimension split over axes A is cut into
    prod(|A|) equal blocks, block i to the rank whose row-major index
    over A is i)."""
    shape = mesh_shape(mesh)
    out = []
    for dim, entry in zip(leaf_shape, list(spec) + [None] * len(leaf_shape)):
        axes = entry_axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        n = entry_extent(shape, entry)
        if dim % n:
            raise ValueError(f'{dim} does not split over {axes} ({n})')
        i = 0
        for a in axes:
            i = i * shape[a] + coords[a]
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


def block_shape(spec: Spec, leaf_shape, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf."""
    shape = mesh_shape(mesh)
    entries = list(spec) + [None] * len(leaf_shape)
    return tuple(dim // entry_extent(shape, e)
                 for dim, e in zip(leaf_shape, entries))


def block_bytes(leaves_shapes: Dict[str, Tuple[int, ...]],
                specs: Dict[str, Spec], mesh,
                itemsize: Dict[str, int]) -> int:
    """Bytes of one rank's blocks of the leaves {path: shape} at
    ``itemsize`` {path: bytes an element}."""
    return sum(math.prod(block_shape(specs[p], s, mesh)) * itemsize[p]
               for p, s in leaves_shapes.items())


def shard(full, specs: Dict[str, Spec], mesh,
          coords: Optional[Dict[str, int]] = None):
    """The rank's blocks of the tree ``full`` (``coords`` default: the
    production mesh's own rank's)."""
    coords = mesh.coords if coords is None else coords
    return tree.unflatten(full, [
        leaf[block_slices(specs[p], tuple(leaf.shape), mesh, coords)]
        for p, leaf in zip(tree.paths(full), tree.leaves(full))])


def unshard(parts: Sequence[Any], specs: Dict[str, Spec], mesh,
            full_shapes: Dict[str, Tuple[int, ...]]):
    """The full tree from ``parts``, every rank's block tree in rank order
    (row-major over the mesh); ``full_shapes`` {path: shape}."""
    shape = mesh_shape(mesh)
    first = parts[0]
    out = []
    for i, (p, leaf) in enumerate(zip(tree.paths(first),
                                      tree.leaves(first))):
        full = torch.empty(full_shapes[p], dtype=leaf.dtype,
                           device=leaf.device)
        for rank, part in enumerate(parts):
            sl = block_slices(specs[p], full_shapes[p], shape,
                              coords_of(shape, rank))
            full[sl] = tree.leaves(part)[i]
        out.append(full)
    return tree.unflatten(first, out)


def shapes_of(t) -> Dict[str, Tuple[int, ...]]:
    """{path: shape} of a tree of tensors."""
    return {p: tuple(x.shape) for p, x in zip(tree.paths(t), tree.leaves(t))}
