"""Replica-to-device placement for the serving fleet (port of
``keystone_tpu/parallel/placement.py``).

Replica ``i`` serves on the data-axis slot ``i % n`` of the default mesh
(``parallel/mesh.py``): one slot a visible CUDA device, or the provisioned
virtual devices; or on the one device the caller names (the CPU when the
caller asks for it). A replica is given its slot's physical device. On a
machine with one card, ``replica_devices(4)`` is four replicas co-resident
on ``cuda:0``, each replaying its own CUDA graphs on its own stream, so one
replica's host work (validation, stacking, the copies) overlaps another's
replay; and ``replica_devices(None)`` is one replica. With 8 virtual
devices provisioned, ``replica_devices(None)`` is 8 replicas on the CPU,
as the JAX package's fleet is 8 replicas on its 8 virtual devices.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from .mesh import default_mesh


def data_axis_devices(device: Any = None, mesh=None) -> List[torch.device]:
    """The devices replicas are placed over: ``[device]`` when the caller
    names one (``"cpu"``, ``"cuda:0"``), else the physical device of each
    data-axis slot of ``mesh`` (default: the default mesh). With no card,
    no virtual device and no device named this raises: the CPU is used only
    when asked for."""
    if device is not None:
        return [torch.device(device)]
    if mesh is None:
        try:
            mesh = default_mesh()
        except RuntimeError:
            raise RuntimeError("no CUDA device is visible; pass device='cpu' to place "
                               "replicas on the CPU") from None
    return [s.device for s in mesh.devices[:, 0].flat]


def worker_device_indices(worker_id: int, n_workers: int, device: Any = None,
                          mesh=None) -> List[int]:
    """The data-axis indices one cluster worker process owns: worker ``w``
    of ``W`` over ``D`` devices owns ``[wD/W, (w+1)D/W)``; with more
    workers than devices, workers share (``[w % D]``)."""
    if not 0 <= worker_id < n_workers:
        raise ValueError(f"worker_id {worker_id} outside [0, {n_workers})")
    n_dev = len(data_axis_devices(device, mesh))
    if n_dev < n_workers:
        return [worker_id % n_dev]
    lo = worker_id * n_dev // n_workers
    hi = (worker_id + 1) * n_dev // n_workers
    return list(range(lo, hi))


def replica_devices(n: Optional[int] = None, device: Any = None,
                    mesh=None) -> List[torch.device]:
    """The device of each of ``n`` serving replicas, round robin over
    :func:`data_axis_devices`; ``n=None`` is one replica a device."""
    devs = data_axis_devices(device, mesh)
    if n is None:
        n = len(devs)
    if n < 1:
        raise ValueError(f"need at least one replica, got {n}")
    return [devs[i % len(devs)] for i in range(n)]
