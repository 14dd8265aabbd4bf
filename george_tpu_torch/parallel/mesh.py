# -*- coding: utf-8 -*-
"""Process meshes over ``torch.distributed``.

The JAX package names the axes of a device mesh and runs its parallel code
inside ``shard_map``.  Here one process (a rank) stands for one device,
and a mesh arranges the ranks of the process group in a grid whose axes
carry the same names:

  * axis ``"chains"`` — data parallelism over MCMC chains / SMC particles;
  * axis ``"data"`` — sharding of the N (dataset) axis of the GP.

For each axis a mesh gives its size (what the JAX code reads as
``mesh.shape[axis]``), this rank's index along it, and the process group
of the ranks that share this rank's place on the other axes.  The caller
initializes the process group (``torch.distributed.init_process_group``,
as ``torchrun`` does); every rank builds the same mesh, in the same order
as every other mesh it builds (group creation is collective).

Groups are made with ``torch.distributed.new_group``, one a row and one a
column, not through ``DeviceMesh``: a ``DeviceMesh`` puts rank r on card
``r % device_count``, while several ranks may share one card (the device
is each rank's own, from :func:`resolve_device`).
"""

from typing import NamedTuple

import torch.distributed as dist

from .._device import resolve_device

__all__ = ["Axis", "Mesh", "chain_mesh", "chain_data_mesh", "world_axis",
           "shard"]


class Axis(NamedTuple):
    """One mesh axis as this rank sees it."""

    name: str
    size: int       # ranks along the axis
    index: int      # this rank's place on it
    group: object   # the ranks along it (None: the default group)


class Mesh(object):
    """Named axes over the ranks of the process group, and this rank's
    device."""

    def __init__(self, axes, device):
        self.axes = {a.name: a for a in axes}
        self.axis_names = tuple(a.name for a in axes)
        self.shape = {a.name: a.size for a in axes}
        self.device = device

    def axis(self, name):
        try:
            return self.axes[name]
        except KeyError:
            raise ValueError("the mesh has axes {0}, not '{1}'".format(
                self.axis_names, name))


def _world():
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "initialize the process group first "
            "(torch.distributed.init_process_group, or run under torchrun)")
    return dist.get_world_size(), dist.get_rank()


def world_axis(name):
    """An axis over every rank of the default group."""
    size, rank = _world()
    return Axis(name, size, rank, None)


def chain_mesh(num_devices=None, axis="chains", device=None):
    """A 1-D mesh over all ranks; ``num_devices``, if given, must be the
    world size (one rank a device)."""
    size, _ = _world()
    if num_devices is not None and num_devices != size:
        raise ValueError("chain_mesh over {0} devices needs {0} ranks; the "
                         "process group has {1}".format(num_devices, size))
    return Mesh([world_axis(axis)], resolve_device(device))


def chain_data_mesh(chain_devices, data_devices, axes=("chains", "data"),
                    device=None):
    """A 2-D (chains x data) mesh: rank r sits at (r // data_devices,
    r % data_devices), as the JAX package reshapes its device list."""
    size, rank = _world()
    if chain_devices * data_devices != size:
        raise ValueError("a {0} x {1} mesh needs {2} ranks; the process "
                         "group has {3}".format(chain_devices, data_devices,
                                                chain_devices * data_devices,
                                                size))
    row, col = divmod(rank, data_devices)
    chain_axis = data_axis = None
    # Every rank creates every group, in the same order.
    for d in range(data_devices):
        group = dist.new_group([c * data_devices + d
                                for c in range(chain_devices)])
        if d == col:
            chain_axis = Axis(axes[0], chain_devices, row, group)
    for c in range(chain_devices):
        group = dist.new_group([c * data_devices + d
                                for d in range(data_devices)])
        if c == row:
            data_axis = Axis(axes[1], data_devices, col, group)
    return Mesh([chain_axis, data_axis], resolve_device(device))


def shard(x, axis):
    """This rank's contiguous block of the rows of ``x`` (the shard that
    ``PartitionSpec(axis)`` gives a device)."""
    n = x.shape[0]
    if n % axis.size:
        raise ValueError("{0} rows do not divide over the {1} ranks of axis "
                         "'{2}'".format(n, axis.size, axis.name))
    step = n // axis.size
    return x[axis.index * step:(axis.index + 1) * step]
