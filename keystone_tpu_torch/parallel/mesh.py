"""The device mesh and its layouts (port of ``keystone_tpu/parallel/mesh.py``).

A :class:`Mesh` is a 2-D array of device *slots* with the axis names
``("data", "model")``: rows of design matrices go over the data axis
(data parallelism), feature and class blocks over the model axis (model
parallelism), as in the JAX package.

A slot (:class:`Slot`) is a numbered place on one physical ``torch.device``.
Torch has one CPU device, so the JAX package's N virtual CPU devices are
N slots of the CPU here (``parallel/virtual.py``), and a mesh on one card
may hold several slots of ``cuda:0`` (``make_mesh(devices=virtual_slots(4,
"cuda:0"))``). The mesh, the scan lanes and the placements hold slots; a
tensor lives on its slot's physical device, so work placed on two slots of
one device runs on that device. That keeps the structure of the JAX
package's mesh (which lane a chunk goes to, which partial crosses to
another slot and is counted as a collective) without claiming memory or
parallelism that one device does not have.

The default mesh is, in order: the one set by :func:`set_default_mesh` or
:func:`use_mesh`; a mesh over the provisioned virtual devices; a mesh over
every visible CUDA device. With none of these, :func:`default_mesh` raises:
the CPU is used only when asked for. Callers that need only a count read
1 then (:func:`mesh_size`, ``lanes.scan_lanes``): the one-lane path. A
mesh built only from the visible cards also gives one scan lane unless
``KEYSTONE_SCAN_LANES`` asks for more (:func:`mesh_was_chosen`).

Layouts: :func:`batch_sharding`, :func:`replicated_sharding` and
:func:`column_sharding` return :class:`NamedSharding` descriptors.
:func:`shard_batch`, :func:`shard_classes` and :func:`replicate` choose a
layout as the JAX package does (falling back to replication when the
length does not divide the axis) and record it on the tensor they return
(:func:`sharding_of`). A host array is placed on the mesh's first slot's
device; a tensor keeps its device. No tensor is split across devices: the
port computes a placed tensor's work on the device it lives on.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Slot:
    """Slot ``index`` of the physical device ``device``: one device of a
    mesh."""

    index: int
    device: torch.device

    def __str__(self) -> str:
        return f"{self.device}#{self.index}"


def physical(d: Any) -> torch.device:
    """The device ``d`` names, a CUDA device with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def as_slot(d: Any, index: int) -> Slot:
    """``d`` as a slot: itself, or slot ``index`` of the device ``d`` names."""
    return d if isinstance(d, Slot) else Slot(index, physical(d))


class Mesh:
    """A 2-D array of slots with the axis names ``(data, model)``."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → its size."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(s) for s in self.devices.flat]})"


# The process-wide default mesh, set by set_default_mesh / use_mesh (None: built
# per call over the provisioned or visible devices, so it follows them).
_default_mesh: Optional[Mesh] = None


def _visible_slots() -> List[Slot]:
    """The provisioned virtual devices, else one slot a visible CUDA device."""
    from .virtual import provisioned

    slots = provisioned()
    if slots:
        return list(slots)
    return [Slot(i, torch.device("cuda", i)) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A ``(data, model)`` mesh over ``devices`` (slots, or devices that
    become slot i of themselves; default: the provisioned virtual devices,
    else every visible CUDA device). ``n_data=None`` puts every remaining
    slot on the data axis."""
    if devices is None:
        devices = _visible_slots()
        if not devices:
            raise RuntimeError(
                "no CUDA device is visible and no virtual device is provisioned; "
                "pass devices= (e.g. virtual_slots(n, 'cpu')) or provision_virtual_devices(n)")
    slots = [as_slot(d, i) for i, d in enumerate(devices)]
    if n_data is None:
        n_data = len(slots) // n_model
    use = n_data * n_model
    if use > len(slots) or n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model} needs {use} devices, have {len(slots)}")
    grid = np.empty((n_data, n_model), dtype=object)
    for i, s in enumerate(slots[:use]):
        grid[i // n_model, i % n_model] = s
    return Mesh(grid)


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    global _default_mesh
    _default_mesh = mesh


def default_mesh() -> Mesh:
    """The process's default mesh (see the module docstring); raises when
    no device is visible or provisioned."""
    return _default_mesh if _default_mesh is not None else make_mesh()


def mesh_or_none(mesh: Optional[Mesh] = None) -> Optional[Mesh]:
    """``mesh``, else the default mesh, else None when there is none."""
    if mesh is not None or _default_mesh is not None:
        return mesh if mesh is not None else _default_mesh
    slots = _visible_slots()
    return make_mesh(devices=slots) if slots else None


def mesh_was_chosen() -> bool:
    """Whether the default mesh was set (:func:`set_default_mesh`,
    :func:`use_mesh`) or virtual devices were provisioned, rather than
    built from the visible cards."""
    from .virtual import provisioned

    return _default_mesh is not None or bool(provisioned())


def mesh_size() -> int:
    """The default mesh's slot count: the machine count the cost models
    price (1 when there is no mesh)."""
    m = mesh_or_none()
    return 1 if m is None else m.size


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Set the process's default mesh for the block."""
    global _default_mesh
    prev = _default_mesh
    _default_mesh = mesh
    try:
        yield mesh
    finally:
        _default_mesh = prev


# -- layouts ------------------------------------------------------------------


@dataclass(frozen=True)
class NamedSharding:
    """A layout on a mesh: ``spec[i]`` names the axis dimension i is split
    over, or None (replicated along it); an empty spec is fully replicated.
    The JAX package's ``NamedSharding(mesh, PartitionSpec(*spec))``."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def batch_sharding(mesh: Optional[Mesh] = None, ndim: int = 2) -> NamedSharding:
    """Rows over the data axis, every other dimension replicated."""
    return NamedSharding(mesh or default_mesh(), (DATA_AXIS,) + (None,) * (ndim - 1))


def replicated_sharding(mesh: Optional[Mesh] = None) -> NamedSharding:
    """Fully replicated: a broadcast of a model."""
    return NamedSharding(mesh or default_mesh(), ())


def column_sharding(mesh: Optional[Mesh] = None, ndim: int = 2) -> NamedSharding:
    """The last dimension over the model axis (feature blocks)."""
    return NamedSharding(mesh or default_mesh(), (None,) * (ndim - 1) + (MODEL_AXIS,))


def sharding_of(x: Any) -> Optional[NamedSharding]:
    """The layout :func:`shard_batch`, :func:`shard_classes` or
    :func:`replicate` recorded on ``x``, or None."""
    return getattr(x, "_sharding", None)


def _placed(x: Any, sharding: NamedSharding) -> torch.Tensor:
    """``x`` as a tensor with ``sharding`` recorded: a host array on the
    mesh's first slot's device, a tensor where it is (as a new alias, so
    the caller's tensor is not annotated)."""
    if isinstance(x, torch.Tensor):
        t = x.view_as(x)
    else:
        t = torch.as_tensor(np.asarray(x), device=sharding.mesh.devices.flat[0].device)
    t._sharding = sharding
    return t


def shard_batch(x: Any, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` laid out by rows over the data axis; replicated when its
    length does not divide the axis (zero-pad with :func:`pad_to_multiple`
    where padding is harmless: Grams and QR, not means or counts). With no
    mesh at all, ``x`` is returned as it is."""
    m = mesh_or_none(mesh)
    if m is None:
        return x
    ndim = np.ndim(x)
    if ndim == 0 or x.shape[0] % m.shape[DATA_AXIS] != 0:
        return _placed(x, replicated_sharding(m))
    return _placed(x, batch_sharding(m, ndim))


def shard_classes(x: Any, axis: int = 0, mesh: Optional[Mesh] = None) -> Any:
    """``x`` laid out along ``axis`` over the model axis (each model slot
    takes its classes' systems); replicated when the length does not
    divide the axis; ``x`` itself on a data-only mesh or with no mesh."""
    m = mesh_or_none(mesh)
    if m is None or m.shape[MODEL_AXIS] <= 1:
        return x
    ndim = np.ndim(x)
    if ndim == 0 or x.shape[axis] % m.shape[MODEL_AXIS] != 0:
        return _placed(x, replicated_sharding(m))
    spec = [None] * ndim
    spec[axis] = MODEL_AXIS
    return _placed(x, NamedSharding(m, tuple(spec)))


def replicate(x: Any, mesh: Optional[Mesh] = None) -> torch.Tensor:
    return _placed(x, replicated_sharding(mesh))


def mesh_n_data(mesh: Optional[Mesh] = None) -> int:
    return (mesh or default_mesh()).shape[DATA_AXIS]


def pad_to_multiple(x: Any, multiple: int, axis: int = 0) -> Tuple[torch.Tensor, int]:
    """``x`` zero-padded along ``axis`` to a multiple of ``multiple``, and
    its length before."""
    x = torch.as_tensor(x)
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = list(x.shape)
    pad[axis] = rem
    return torch.cat([x, x.new_zeros(pad)], dim=axis), n
