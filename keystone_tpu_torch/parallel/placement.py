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

Each physical device that a fleet or a laned scan uses holds its own copy of
the fitted chain (:func:`copy_to_device`), as each JAX device holds its own
copy of the parameters placed there; replicas and lanes on slots of one
device share one copy, so on one card nothing is copied.
"""

from __future__ import annotations

import threading
import types
import weakref
from collections import Counter
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .mesh import default_mesh, physical


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


# -- the per-device copy of a fitted chain ----------------------------------

#: shared, never copied: immutable values, host arrays (the host is every
#: device's), and what a function or class names rather than holds
_SHARED = (type(None), bool, int, float, complex, str, bytes, type, range, slice,
           torch.device, torch.dtype, torch.Size, np.ndarray, np.generic, np.dtype,
           types.ModuleType, types.BuiltinFunctionType, types.CodeType, weakref.ref)
#: a lock of the source becomes a new lock of the copy
_LOCKS: Dict[type, Callable[[], Any]] = {type(threading.Lock()): threading.Lock,
                                          type(threading.RLock()): threading.RLock}


class _Walk:
    """One walk over everything reachable from an object, as pickling
    reaches it (an object's ``__getstate__`` decides what it carries, so
    CUDA graphs and compile memos stay behind), plus the cells of closures
    and the halves of bound methods, which pickling would refuse. Every
    object is met once (a memo by identity), so what two holders shared
    stays shared.

    Without ``moved`` the walk only visits and gathers the tensors it
    meets (:attr:`tensors`). With it, the walk builds a copy in which each
    tensor is ``moved[id(tensor)]``. A class with a ``device_copy(copy)``
    method (a segment dispatcher, which holds its device's programs and
    graphs) builds its own fresh copy, calling ``copy`` on what it keeps;
    only that is visited."""

    def __init__(self, moved: Optional[Dict[int, torch.Tensor]] = None):
        self._moved = moved
        self._memo: Dict[int, Any] = {}
        self._keep: List[Any] = []  # ids stay unique while the walk runs
        self.tensors: List[torch.Tensor] = []

    def __call__(self, obj: Any) -> Any:
        key = id(obj)
        if key in self._memo:
            return self._memo[key]
        out = self._one(obj)
        self._memo[key] = out
        self._keep.append(obj)
        return out

    def _enter(self, obj: Any, out: Any) -> Any:
        self._memo[id(obj)] = out
        self._keep.append(obj)
        return out

    def _one(self, obj: Any) -> Any:
        build = self._moved is not None
        if isinstance(obj, torch.Tensor):
            if not build:
                self.tensors.append(obj)
                return obj
            return self._moved[id(obj)]
        if isinstance(obj, _SHARED):
            return obj
        cls = type(obj)
        if cls in _LOCKS:
            return _LOCKS[cls]() if build else obj
        if hasattr(cls, "device_copy"):
            out = obj.device_copy(self)  # visits what it keeps either way
            return out if build else obj
        if cls is list:
            out = self._enter(obj, [] if build else obj)
            items = [self(x) for x in obj]
            if build:
                out.extend(items)
            return out
        if cls is dict:
            out = self._enter(obj, {} if build else obj)
            items = [(self(k), self(v)) for k, v in obj.items()]
            if build:
                out.update(items)
            return out
        if cls in (tuple, set, frozenset):
            items = [self(x) for x in obj]
            return cls(items) if build else obj
        if cls is types.FunctionType:
            return self._function(obj, build)
        if cls is types.MethodType:
            func, owner = self(obj.__func__), self(obj.__self__)
            return types.MethodType(func, owner) if build else obj
        return self._reduced(obj, build)

    def _function(self, fn: types.FunctionType, build: bool) -> Any:
        if not (fn.__closure__ or fn.__defaults__ or fn.__kwdefaults__):
            return fn  # names what it uses (globals): shared
        cells = tuple(types.CellType() for _ in fn.__closure__ or ())
        out = fn
        if build:
            out = types.FunctionType(fn.__code__, fn.__globals__, fn.__name__, None,
                                     cells or None)
            out.__qualname__, out.__module__, out.__doc__ = (fn.__qualname__, fn.__module__,
                                                              fn.__doc__)
        self._enter(fn, out)  # a closure may hold itself
        defaults, kwdefaults = self(fn.__defaults__), self(fn.__kwdefaults__)
        for cell, src in zip(cells, fn.__closure__ or ()):
            try:
                value = src.cell_contents
            except ValueError:  # a cell not yet filled
                continue
            value = self(value)
            if build:
                cell.cell_contents = value
        if build:
            out.__defaults__, out.__kwdefaults__ = defaults, kwdefaults
            out.__dict__.update(self(fn.__dict__))
        return out

    def _reduced(self, obj: Any, build: bool) -> Any:
        try:
            rv = obj.__reduce_ex__(4)
        except TypeError as e:
            if not build:
                return obj  # visited as opaque: only a copy needs its inside
            raise TypeError(f"a {type(obj).__qualname__} in the chain cannot be copied to "
                            f"another device: {e}") from None
        if isinstance(rv, str):
            return obj  # a global name: shared
        func, args, state, listitems, dictitems = (tuple(rv) + (None,) * 5)[:5]
        args = self(args)
        out = self._enter(obj, func(*args) if build else obj)
        if state is not None:
            state = self(state)
            if build:
                if hasattr(out, "__setstate__"):
                    out.__setstate__(state)
                else:
                    slots = None
                    if isinstance(state, tuple) and len(state) == 2:
                        state, slots = state
                    if state:
                        out.__dict__.update(state)
                    for k, v in (slots or {}).items():
                        setattr(out, k, v)
        for item in listitems or ():
            item = self(item)
            if build:
                out.append(item)
        for k, v in dictitems or ():
            k, v = self(k), self(v)
            if build:
                out[k] = v
        return out


def tensors_of(obj: Any) -> List[torch.Tensor]:
    """Every tensor reachable from ``obj`` at any depth (its operators,
    their containers, nested operators, closures), each once."""
    walk = _Walk()
    walk(obj)
    return walk.tensors


def _home(tensors: List[torch.Tensor]) -> torch.device:
    """The physical device holding most of the tensors' bytes, the CPU for
    none."""
    held: Counter = Counter()
    for t in tensors:
        held[physical(t.device)] += t.numel() * t.element_size()
    return max(held, key=held.get) if held else torch.device("cpu")


def home_device(obj: Any) -> torch.device:
    """Where ``obj`` (a fitted chain) lives: the physical device holding
    most of the bytes of the tensors reachable from it at any depth, the
    CPU when it holds none. A fleet places its replicas there by default and
    serves the chain itself there; :func:`copy_to_device` copies only onto
    another device. An object that cannot be pickled is passed over as
    opaque, so finding the home never fails."""
    return _home(tensors_of(obj))


def _storage_key(t: torch.Tensor) -> Any:
    """What ties ``t`` to the other views of its storage; its own identity
    for a tensor with no shareable storage (sparse, empty, meta)."""
    if t.layout == torch.strided:
        ptr = t.untyped_storage().data_ptr()
        if ptr:
            return (str(t.device), ptr)
    return id(t)


def _like(src: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    if isinstance(src, torch.nn.Parameter):
        return torch.nn.Parameter(out, requires_grad=src.requires_grad)
    return out


def _moved_tensors(tensors: List[torch.Tensor], device: torch.device) -> Dict[int, torch.Tensor]:
    """Each tensor on ``device``: a tensor alone on its storage is copied
    by itself; views of one storage are rebuilt over one copy of it, so
    they stay views of one storage."""
    groups: Dict[Any, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(_storage_key(t), []).append(t)
    moved: Dict[int, torch.Tensor] = {}
    for group in groups.values():
        if len(group) == 1:
            t = group[0]
            moved[id(t)] = _like(t, t.detach().to(device).requires_grad_(t.requires_grad))
            continue
        storage = group[0].untyped_storage()
        raw = torch.empty(0, dtype=torch.uint8, device=group[0].device).set_(
            storage, 0, (storage.nbytes(),), (1,))
        shared = raw.to(device).untyped_storage()
        for t in group:
            view = torch.empty(0, dtype=t.dtype, device=device).set_(
                shared, t.storage_offset(), t.size(), t.stride())
            moved[id(t)] = _like(t, view.requires_grad_(t.requires_grad))
    return moved


def copy_to_device(obj: Any, device: Any) -> Any:
    """``obj`` (a fitted chain, a scan's steps) on the physical device
    ``device``: ``obj`` itself when ``device`` is its :func:`home_device`
    or it holds no tensor, so replicas and lanes on slots of one device
    share it; else a copy in which every tensor reachable at any depth is on
    ``device``. What two holders shared stays shared (CSE'd nodes, the
    training block both a KRR mapper and its kernel loop read), and views
    of one storage stay views of one storage. The copy carries no CUDA
    graph, capture stream or pool, compiled program or dispatcher state of
    the source: each is built again on its device at first use. Its
    content fingerprint is the source's.

    The port's counterpart of the JAX package's per-device ``device_put``
    of a chain's parameters. An object that can be neither pickled nor
    walked (a generator, an open file) raises ``TypeError``."""
    device = physical(device)
    seen = _Walk()
    seen(obj)
    if not seen.tensors or _home(seen.tensors) == device:
        return obj
    return _Walk(_moved_tensors(seen.tensors, device))(obj)
