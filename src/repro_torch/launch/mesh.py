"""The launcher's client mesh (the port of ``repro.launch.mesh``'s
client-axis half: ``client_axes``, ``n_clients``, ``make_host_mesh``).

The mesh itself, :class:`repro_torch.core.mesh.ClientMesh`, lives with
the transports that run on it.  :func:`make_host_mesh` wraps the
initialised default group, or is the one-rank mesh without any process
group (its collectives are the identity).  The production meshes
(``make_production_mesh``, the 'model' axis) come with
``launch/shardings.py`` (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.core.mesh import ClientMesh

CLIENT_AXES = ('data',)


def client_axes(mesh: ClientMesh) -> tuple:
    """The axes that enumerate FL clients: the group's one axis."""
    return CLIENT_AXES


def n_clients(mesh: ClientMesh) -> int:
    """Shards of the client axis."""
    return mesh.size


def make_host_mesh(group=None) -> ClientMesh:
    """``group``, else the initialised default group, as the client axis;
    the one-rank mesh when no group is initialised."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    return ClientMesh(group)
