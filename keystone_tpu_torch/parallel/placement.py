"""Replica-to-device placement for the serving fleet (port of
``keystone_tpu/parallel/placement.py``).

Replica ``i`` serves on device ``i % n`` of the devices it is placed
over: every visible CUDA device, or the one device the caller names (the
CPU when the caller asks for it). On a machine with one card,
``replica_devices(4)`` is four replicas co-resident on ``cuda:0``, each
replaying its own CUDA graphs on its own stream, so one replica's host work
(validation, stacking, the copies) overlaps another's replay; and
``replica_devices(None)`` is one replica.

The JAX package places over the data axis of its device mesh. The port
has no mesh yet: ``parallel/mesh.py``, its lanes and the model-sharded
scans come with ROADMAP Queue 1 item 14b.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch


def data_axis_devices(device: Any = None) -> List[torch.device]:
    """The devices replicas are placed over: ``[device]`` when the caller
    names one (``"cpu"``, ``"cuda:0"``), else every visible CUDA device.
    With no card and no device named this raises: the CPU is used only when
    asked for."""
    if device is not None:
        return [torch.device(device)]
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to place "
                           "replicas on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def worker_device_indices(worker_id: int, n_workers: int, device: Any = None) -> List[int]:
    """The device indices one cluster worker process owns: worker ``w`` of
    ``W`` over ``D`` devices owns ``[wD/W, (w+1)D/W)``; with more workers
    than devices, workers share (``[w % D]``)."""
    if not 0 <= worker_id < n_workers:
        raise ValueError(f"worker_id {worker_id} outside [0, {n_workers})")
    n_dev = len(data_axis_devices(device))
    if n_dev < n_workers:
        return [worker_id % n_dev]
    lo = worker_id * n_dev // n_workers
    hi = (worker_id + 1) * n_dev // n_workers
    return list(range(lo, hi))


def replica_devices(n: Optional[int] = None, device: Any = None) -> List[torch.device]:
    """The device of each of ``n`` serving replicas, round robin over
    :func:`data_axis_devices`; ``n=None`` is one replica a device."""
    devs = data_axis_devices(device)
    if n is None:
        n = len(devs)
    if n < 1:
        raise ValueError(f"need at least one replica, got {n}")
    return [devs[i % len(devs)] for i in range(n)]
