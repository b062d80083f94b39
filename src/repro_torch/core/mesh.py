"""The client axis of the transports (the port of ``repro.kernels.ops``'s
client-axis rule, ``_shard_row0`` and ``_pad_clients``).

The reference shards the FL client axis over the mesh's non-'model' axes
and lets ``shard_map`` hand each device a block of client rows.  Here a
:class:`ClientMesh` wraps a ``torch.distributed`` process group: rank r of
S holds the block of rows ``[r * K_local, (r + 1) * K_local)`` of the K
clients, ``K_local = ceil(K / S)`` (the reference's row-major block), and
K is padded to ``S * K_local`` with dummy rows (zeros: zero-weight rows
whose vote gate is off).  The collectives are the group's ``all_reduce``
(sum) and ``all_gather``; on a group whose backend is gloo a CUDA tensor
goes through the host.

``ClientMesh()`` (no group) is the one-rank mesh whose collectives are
the identity: the transports' gathered collective runs on it, so the
gathered and the sharded calls are one code path.
``launch.mesh.make_host_mesh`` wraps the initialised default group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

Tensor = torch.Tensor


class ClientMesh:
    """The client axis over a process group (``group`` None: one rank, no
    group, every collective the identity)."""

    def __init__(self, group=None):
        self.group = group
        if group is None:
            self.rank, self.size, self.backend = 0, 1, None
        else:
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)
            self.backend = str(dist.get_backend(group))

    def __repr__(self) -> str:
        return (f'ClientMesh(rank={self.rank}, size={self.size}, '
                f'backend={self.backend})')

    @property
    def capturable(self) -> bool:
        """Whether the collectives can be captured in a CUDA graph: none
        are issued (no group) or the group is NCCL's."""
        return self.group is None or self.backend == 'nccl'

    def k_local(self, k: int) -> int:
        """Rows of each rank's block: ceil(K / S)."""
        return -(-int(k) // self.size)

    def row0(self, k: int) -> int:
        """The global index of this rank's first row."""
        return self.rank * self.k_local(k)

    def rows(self, k: int) -> slice:
        """This rank's real rows of the K clients (the block without its
        padding; empty where the block is all padding)."""
        r0 = self.row0(k)
        return slice(min(r0, k), min(r0 + self.k_local(k), k))

    def block(self, x: Tensor, k: int, pad=0) -> Tensor:
        """This rank's (K_local, ...) block of the global (K, ...) ``x``,
        padded with ``pad`` past row K-1 (``x`` itself on one rank)."""
        if self.size == 1:
            return x
        return pad_rows(x[self.rows(k)], self.k_local(k), pad)

    def _host(self, t: Tensor) -> bool:
        return self.backend == 'gloo' and t.device.type == 'cuda'

    def all_reduce(self, t: Tensor, op=None) -> Tensor:
        """The sum (or ``op``, a ``dist.ReduceOp``) of ``t`` over the ranks
        (a new tensor where the group moves it through the host, else
        ``t`` reduced in place)."""
        if self.group is None:
            return t
        op = dist.ReduceOp.SUM if op is None else op
        if self._host(t):
            h = t.cpu()
            dist.all_reduce(h, op=op, group=self.group)
            return h.to(t.device)
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t: Tensor) -> Tensor:
        """Every rank's ``t`` (same shape on each) stacked along dim 0 in
        rank order."""
        if self.group is None:
            return t
        src = t.cpu() if self._host(t) else t.contiguous()
        out = torch.empty((self.size * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        if self.backend == 'nccl':
            dist.all_gather_into_tensor(out, src, group=self.group)
        else:
            dist.all_gather(list(out.chunk(self.size)), src,
                            group=self.group)
        return out.to(t.device)

    def gather_rows(self, local: Tensor, k: int) -> Tensor:
        """The global (K, ...) tensor from each rank's (K_local, ...)
        block (one ``all_gather``; the padding cut)."""
        return self.all_gather(local)[:k]


def pad_rows(x: Tensor, rows: int, value=0) -> Tensor:
    """``x`` with rows appended up to ``rows`` (filled with ``value``)."""
    extra = rows - x.shape[0]
    if extra <= 0:
        return x
    fill = torch.full((extra,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill])
