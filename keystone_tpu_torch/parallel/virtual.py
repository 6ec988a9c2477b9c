"""Virtual devices (port of ``keystone_tpu/parallel/virtual.py``): N slots
of the CPU standing in for N devices, as the JAX package's N virtual XLA
CPU devices stand in for a TPU slice (and Spark's ``local[n]`` for a
cluster in the reference's tests).

Torch has one CPU device, so a virtual device is a numbered slot of it
(``mesh.Slot``). :func:`provision_virtual_devices` makes the process's
default mesh one of n CPU slots; every scan lane, placement and
machine count that reads the default mesh then sees n devices. The
switch is process-wide, as the JAX package's is; unlike it, it tears
nothing down and can be undone (:func:`clear_virtual_devices`), which the
tests do in their fixtures. :func:`virtual_slots` gives slots of any
device without provisioning them: a mesh of 4 slots of ``cuda:0`` is
``make_mesh(devices=virtual_slots(4, "cuda:0"))``.
"""

from __future__ import annotations

from typing import Any, List, Optional

from .mesh import Slot, physical, set_default_mesh

#: the provisioned slots (None: none provisioned)
_slots: Optional[List[Slot]] = None


def virtual_slots(n: int, device: Any = "cpu") -> List[Slot]:
    """``n`` slots of one physical device."""
    if n < 1:
        raise ValueError(f"need at least one virtual device, got {n}")
    dev = physical(device)
    return [Slot(i, dev) for i in range(n)]


def provision_virtual_devices(n_devices: int) -> None:
    """Make the process's devices ``n_devices`` slots of the CPU: the
    default mesh is rebuilt over them (an explicitly set default mesh is
    dropped, as the JAX package's backend is)."""
    global _slots
    _slots = virtual_slots(int(n_devices), "cpu")
    set_default_mesh(None)


def provisioned() -> Optional[List[Slot]]:
    """The provisioned slots, or None."""
    return _slots


def clear_virtual_devices() -> None:
    """Undo :func:`provision_virtual_devices`: the default mesh is built
    over the visible CUDA devices again."""
    global _slots
    _slots = None
    set_default_mesh(None)


def provision_from_env(default: Optional[int] = None) -> int:
    """Provision ``KEYSTONE_VIRTUAL_DEVICES`` slots (or ``default`` when it
    is unset) when more than one is asked for; returns the count, 1 for
    none provisioned."""
    from ..utils import env_int

    n = env_int("KEYSTONE_VIRTUAL_DEVICES", int(default or 1))
    if n > 1:
        provision_virtual_devices(n)
        return n
    return 1
