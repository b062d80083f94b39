"""Tensor parallelism on the 'model' axis: Megatron-style column- and
row-parallel layers, a vocab-parallel embedding and a vocab-parallel
head and cross-entropy.

The reference has no counterpart to this module: its 'model' axis is a
``PartitionSpec`` entry ("attention heads / FFN hidden / vocab rows",
``repro.launch.shardings``), and GSPMD partitions the compute from the
specs.  Here the partition is explicit.  A :class:`TensorParallel`
names which parts of ``cfg`` take it on ``size`` model ranks and carries
the model ranks' process group (a ``core.mesh.ClientMesh``); the model
functions take it as ``tp`` (``None``: the unsharded ops) and compute
with the rank's blocks of the weights (``training.model_axis`` hands
them over):

* attention: when the query heads and the kv heads divide ('heads'),
  ``wq/wk/wv`` (and ``bq/bk/bv``) are column blocks of whole heads and
  ``wo`` a row block, so rank r's query heads use exactly its kv heads;
  when only the query heads divide and each rank's query heads fall in
  one kv group ('q': paligemma's single kv head, granite's 8 kv heads at
  16 ranks), ``wk/wv`` are gathered and the rank takes that kv head;
* the dense MLP (and arctic's dense residual): ``w_gate/w_up`` column
  blocks, ``w_down`` a row block, when ``d_ff`` divides;
* the MoE experts: each expert's ``(E, d, f)`` and ``(E, f, d)`` stacks
  split in f alike; the router is replicated, so routing is the same on
  every rank (its input is whole);
* the embedding (vocab rows) and the head (vocab columns; a tied head is
  the embedding's rows): :func:`vocab_embed` and :func:`vocab_xent`;
* a Mamba2 block, when its SSM heads divide ('ssm'): the rank computes
  its heads' columns of z, x and dt (:func:`ssm_columns`), its heads' x
  channels of the depthwise conv (:func:`conv_channels`) and its slices
  of ``A_log``, ``D`` and ``dt_bias``; B and C (``ssm_state`` columns
  each) are computed whole on every rank from their whole columns of
  ``in_proj`` and their conv channels (d x 2 s: small); the output norm
  takes its mean of squares over the whole inner width, a float32 sum
  over the ranks (:func:`gated_rms_norm`); ``out_proj`` is a row block.

Each rule stands alone, so an attention-free model (Mamba2) takes the
SSM and vocabulary rules where they divide: mamba2-130m's 24 heads and
its vocabulary of 50,280 divide 2 model ranks, not 16; zamba2-2.7b's 80
heads divide 16.

The two operators around a parallel block are :func:`copy_to` (identity
forward, a sum over the model ranks of the cotangent backward; before a
column-parallel block) and :func:`reduce_from` (the sum forward, identity
backward; after a row-parallel block).  Each is a
``torch.autograd.Function`` with an explicit ``vmap`` rule that sums the
whole batched ``(K_local, ...)`` tensor in one collective: a generated
rule would hand the collective a ``BatchedTensor``.  The sums run on any
backend of the group: gloo (the CPU tests, through the host for a card's
tensors), NCCL, and the dry run's fake group.

Every product of a split layer is taken in float32 (:func:`column`,
:func:`row`): its operands are cast up (a product of two bf16 values is
exact in float32), a row block's partial sum stays in float32 through
the sum over the ranks, and the sum rounds to the product's dtype once,
as the unsharded product's float32 accumulation does; a column block's
input takes its cotangent the same way, one float32 sum over the ranks
for all the products that share it, rounded once.  A bf16 step is still
not the unsharded step's bits: the sums are grouped otherwise, and
their rounding moves a deep bf16 pass as much as any change of its
products' rounding does (``chip_smoke.tp_gradient_errors``).  The price
is a float32 GEMM where the unsharded pass runs a bf16 one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mesh import ClientMesh
from repro_torch.models.common import dot, softcap

Tensor = torch.Tensor


@dataclass(frozen=True)
class TensorParallel:
    """Which parts of a model take tensor parallelism on ``size`` model
    ranks (this rank ``rank`` of ``mesh``, the model ranks' group)."""
    mesh: ClientMesh
    rank: int
    size: int
    attn: Optional[str]         # 'heads', 'q' or None (gathered)
    kv_head: int                # 'q': the one kv head of this rank
    mlp: bool
    moe: bool
    vocab: bool
    ssm: bool


def partition(cfg: ModelConfig, mesh: ClientMesh) -> TensorParallel:
    """The parts of ``cfg`` that divide over the ``mesh.size`` model
    ranks (each rule as the module docstring gives it; none on one
    rank)."""
    m, r = mesh.size, mesh.rank
    h, kv = cfg.n_heads, cfg.n_kv_heads
    split = m > 1
    attn, kv_head = None, 0
    if split and not cfg.attention_free and h and h % m == 0:
        per_rank, group = h // m, h // kv
        if kv % m == 0:
            attn = 'heads'
        elif group % per_rank == 0:
            attn, kv_head = 'q', (r * per_rank) // group
    ff = split and cfg.d_ff > 0 and cfg.d_ff % m == 0
    return TensorParallel(
        mesh=mesh, rank=r, size=m, attn=attn, kv_head=kv_head,
        mlp=ff and (not cfg.is_moe or cfg.dense_residual),
        moe=ff and cfg.is_moe,
        vocab=split and cfg.vocab_size % m == 0,
        ssm=(split and 'mamba' in cfg.layer_pattern
             and cfg.ssm_heads % m == 0))


def ssm_heads(cfg: ModelConfig, rank: int, size: int) -> slice:
    """Model rank ``rank``'s SSM heads of ``size``."""
    n = cfg.ssm_heads // size
    return slice(rank * n, (rank + 1) * n)


def conv_channels(cfg: ModelConfig, rank: int, size: int) -> list:
    """Model rank ``rank``'s channels of the depthwise conv's ``x | B |
    C``: its heads' x channels, then B and C whole."""
    inner, s = cfg.ssm_inner, cfg.ssm_state
    n = inner // size
    return (list(range(rank * n, (rank + 1) * n))
            + list(range(inner, inner + 2 * s)))


def ssm_columns(cfg: ModelConfig, rank: int, size: int) -> list:
    """Model rank ``rank``'s columns of ``in_proj``'s ``z | x | B | C |
    dt``: its heads' z and x columns, B and C whole, its heads' dt."""
    inner, s = cfg.ssm_inner, cfg.ssm_state
    n = inner // size
    heads = ssm_heads(cfg, rank, size)
    return (list(range(rank * n, (rank + 1) * n))
            + [inner + c for c in conv_channels(cfg, rank, size)]
            + list(range(2 * inner + 2 * s + heads.start,
                         2 * inner + 2 * s + heads.stop)))


# ---------------------------------------------------------------------------
# the two operators
# ---------------------------------------------------------------------------

def _all_reduce(x: Tensor, mesh: ClientMesh, op) -> Tensor:
    """``op`` of ``x`` over the ranks, as a new tensor (``x`` untouched)."""
    return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format),
                           op)


class _Reduce(torch.autograd.Function):
    """``op`` over the model ranks forward, the identity backward."""

    @staticmethod
    def forward(x, mesh, op):
        return _all_reduce(x, mesh, op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, op):
        return _Reduce.apply(x, mesh, op), in_dims[0]


class _Copy(torch.autograd.Function):
    """The identity forward, the sum over the model ranks backward."""

    @staticmethod
    def forward(x, mesh):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return reduce_sum(g, ctx.mesh), None

    @staticmethod
    def vmap(info, in_dims, x, mesh):
        return _Copy.apply(x, mesh), in_dims[0]


def reduce_sum(x: Tensor, mesh: ClientMesh) -> Tensor:
    """The sum of ``x`` over ``mesh``, in float32, cast back to x's
    dtype (the identity backward)."""
    s = _Reduce.apply(x.to(torch.float32), mesh, dist.ReduceOp.SUM)
    return s.to(x.dtype)


def copy_to(x: Tensor, tp: TensorParallel) -> Tensor:
    """``x`` as is; its cotangent summed over the model ranks (Megatron's
    f, before a column-parallel block)."""
    return _Copy.apply(x, tp.mesh)


def reduce_from(x: Tensor, tp: TensorParallel) -> Tensor:
    """The sum of the ranks' partial ``x`` (Megatron's g, after a
    row-parallel block)."""
    return reduce_sum(x, tp.mesh)


def column(x: Tensor, tp: TensorParallel):
    """The rank's column products of ``x`` (whole, the block's input):
    ``x`` goes to float32 once, and its cotangent, the float32 sum of
    its products' partials, is summed over the model ranks and rounds to
    x's dtype once (Megatron's f).  -> ``prod(w, product=dot)``: the
    product with the rank's column block ``w``, taken in float32 and
    rounded to x's dtype once."""
    x32 = copy_to(x.to(torch.float32), tp)

    def prod(w: Tensor, product=dot) -> Tensor:
        return product(x32, w.to(torch.float32)).to(x.dtype)

    return prod


def row(x: Tensor, w: Tensor, tp: TensorParallel, product=dot) -> Tensor:
    """``product(x, w)`` with ``w`` the rank's row block and ``x`` the
    rank's columns: the float32 partials summed over the model ranks,
    rounded to x's dtype once (Megatron's g)."""
    return reduce_from(product(x.to(torch.float32), w.to(torch.float32)),
                       tp).to(x.dtype)


def gated_rms_norm(x: Tensor, z: Tensor, scale: Tensor, eps: float,
                   tp: TensorParallel) -> Tensor:
    """``common.gated_rms_norm`` of the rank's channels ``x`` and ``z``
    (``scale`` its block): the mean of squares over the whole inner
    width, a float32 sum over the model ranks before the rsqrt; its
    cotangent is summed over them too (each rank's sum feeds its own
    channels)."""
    dt = x.dtype
    gate = F.silu(z.to(torch.float32)).to(dt)
    y = (x * gate).to(torch.float32)
    n = y.shape[-1] * tp.size
    ssq = reduce_sum(copy_to(torch.sum(torch.square(y), dim=-1,
                                       keepdim=True), tp), tp.mesh)
    y = y * torch.rsqrt(ssq / n + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dt)


def gather_columns(x: Tensor, tp: TensorParallel) -> Tensor:
    """Every model rank's last-dimension block of ``x`` concatenated in
    rank order (the vocabulary-split head's logits: no gradient)."""
    parts = tp.mesh.all_gather(x.detach().movedim(-1, 0).contiguous())
    return parts.movedim(0, -1)


def max_over(x: Tensor, tp: TensorParallel) -> Tensor:
    """The largest ``x`` over the model ranks, carrying no gradient."""
    return _Reduce.apply(x.detach(), tp.mesh, dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# the vocabulary
# ---------------------------------------------------------------------------

def _vocab_rows(labels: Tensor, n: int, tp: TensorParallel):
    """(labels as this rank's row indices, clamped into [0, n); whether
    each label is one of this rank's ``n`` rows)."""
    local = labels.to(torch.int64) - tp.rank * n
    inside = (local >= 0) & (local < n)
    return torch.where(inside, local, torch.zeros_like(local)), inside


def vocab_embed(tokens: Tensor, block: Tensor, tp: TensorParallel
                ) -> Tensor:
    """The embedding of ``tokens`` from the rank's (V / size, D) rows:
    a token outside them looks up zeros; the sum over the ranks holds
    each token's row once (exact)."""
    idx, inside = _vocab_rows(tokens, block.shape[0], tp)
    rows = F.embedding(idx, block)
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from(rows, tp)


def vocab_xent(x: Tensor, head_t: Tensor, labels: Tensor, mask: Tensor,
               logit_softcap_val: float, tp: TensorParallel,
               chunk: int = 512) -> Tensor:
    """``common.chunked_softmax_xent`` with the rank's (D, V / size)
    columns of the head, chunk for chunk: the rank's logits (a
    :func:`column` product, softcapped in the parameters' dtype, cast to
    float32), the row maximum over the ranks (no gradient), the sum over
    the ranks of the exponentials and of the gold logit (the rank that
    holds the label adds it)."""
    dtype = x.dtype
    x = copy_to(x.to(torch.float32), tp)
    head_t = head_t.to(torch.float32)
    T = x.shape[1]
    n_chunks = max(1, (T + chunk - 1) // chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = torch.matmul(x[:, sl], head_t).to(dtype)
        logits = softcap(logits, logit_softcap_val).to(torch.float32)
        top = max_over(torch.amax(logits, dim=-1), tp)
        sumexp = reduce_from(torch.sum(torch.exp(logits - top[..., None]),
                                       dim=-1), tp)
        logz = torch.log(sumexp) + top
        idx, inside = _vocab_rows(labels[:, sl], head_t.shape[1], tp)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = reduce_from(torch.where(inside, gold,
                                       torch.zeros_like(gold)), tp)
        nll = (logz - gold) * mask[:, sl]
        total = total + torch.sum(nll)
    denom = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
    return total / denom
