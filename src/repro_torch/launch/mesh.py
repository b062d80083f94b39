"""Meshes of the launcher (the port of ``repro.launch.mesh``).

Single pod: 256 ranks as (data=16, model=16).  Multi-pod: 2 x 256 ranks
as (pod=2, data=16, model=16); the 'pod' axis extends the FL client axis
across pods (32 clients).

:func:`make_production_mesh` lays the initialised process group out
row-major over the axes (rank r's coordinates are ``np.unravel_index(r,
shape)``) as a :class:`ProductionMesh`: one process group for every
non-empty set of axes (the ranks whose other coordinates equal this
rank's; the world group for all of them), and ``clients``, a
``core.mesh.ClientMesh`` over the client axes (every axis but 'model'),
on which the sharded transports (``collective='sharded'``) run as they
do on a host mesh.  The world size must be the product of the shape.
:func:`make_host_mesh` is the one-axis client mesh of the initialised
default group (the one-rank mesh without one).

Defined as functions and classes: importing this module touches no
process group.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.core.mesh import ClientMesh

SINGLE_POD_SHAPE = (16, 16)
SINGLE_POD_AXES = ('data', 'model')
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ('pod', 'data', 'model')
MODEL = 'model'
CLIENT_AXES = ('data',)


class ProductionMesh:
    """``shape`` over ``axes`` laid row-major on the initialised default
    group."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        self.axes = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axes, map(int, shape)))
        self.size = math.prod(self.shape.values())
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f'a {dict(self.shape)} mesh needs {self.size} '
                             f'ranks; the group has {world}')
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        self.coords: Dict[str, int] = dict(zip(self.axes, map(
            int, np.unravel_index(self.rank, tuple(self.shape.values())))))
        self._groups = {}
        layout = np.arange(self.size).reshape(tuple(self.shape.values()))
        for n in range(1, len(self.axes) + 1):
            for sub in itertools.combinations(range(len(self.axes)), n):
                if n == len(self.axes):
                    self._groups[self.axes] = dist.group.WORLD
                    continue
                rest = [i for i in range(len(self.axes)) if i not in sub]
                rows = np.transpose(layout, rest + list(sub)).reshape(
                    -1, math.prod(layout.shape[i] for i in sub))
                mine, _ = dist.new_subgroups_by_enumeration(
                    [[int(r) for r in row] for row in rows])
                self._groups[tuple(self.axes[i] for i in sub)] = mine
        self.client_axes = tuple(a for a in self.axes if a != MODEL)
        self.clients = self.axis_mesh(self.client_axes)

    def __repr__(self) -> str:
        return (f'ProductionMesh({self.shape}, rank={self.rank}, '
                f'coords={self.coords}, backend={self.backend})')

    def ordered(self, axes) -> Tuple[str, ...]:
        """``axes`` (an axis name or a tuple of them) as a tuple, which
        must list them in the mesh's order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if list(axes) != [a for a in self.axes if a in axes]:
            raise ValueError(f'axes {axes} are not in the mesh order '
                             f'{self.axes}')
        return axes

    def axis_mesh(self, axes) -> ClientMesh:
        """The ranks along ``axes`` through this rank as a ``ClientMesh``
        (its rank: this rank's row-major index over ``axes``)."""
        return ClientMesh(self._groups[self.ordered(axes)])

    def extent(self, axes) -> int:
        """Ranks along ``axes``."""
        return math.prod(self.shape[a] for a in self.ordered(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        out = 0
        for a in self.ordered(axes):
            out = out * self.shape[a] + self.coords[a]
        return out


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """The single-pod (16, 16) or the multi-pod (2, 16, 16) mesh over the
    initialised default group of 256 or 512 ranks."""
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    axes = MULTI_POD_AXES if multi_pod else SINGLE_POD_AXES
    return ProductionMesh(shape, axes)


def client_axes(mesh) -> tuple:
    """Mesh axes that enumerate FL clients: every axis but 'model' of a
    production mesh, the one axis of a client mesh."""
    if isinstance(mesh, ProductionMesh):
        return mesh.client_axes
    return CLIENT_AXES


def n_clients(mesh) -> int:
    """Shards of the client axes."""
    if isinstance(mesh, ProductionMesh):
        return mesh.clients.size
    return mesh.size


def make_host_mesh(group=None) -> ClientMesh:
    """``group``, else the initialised default group, as the client axis;
    the one-rank mesh when no group is initialised."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    return ClientMesh(group)


def mesh_shape(mesh) -> Dict[str, int]:
    """The axis sizes of a production mesh, or a mapping of them."""
    return dict(mesh.shape if isinstance(mesh, ProductionMesh) else mesh)


def coords_of(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """The coordinates of ``rank`` laid row-major over ``shape``."""
    return dict(zip(shape, map(int, np.unravel_index(
        rank, tuple(shape.values())))))

