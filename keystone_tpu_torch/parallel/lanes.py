"""Scan lanes (port of ``keystone_tpu/parallel/lanes.py``): the chunks of an
out-of-core scan dealt round robin over the data axis of the mesh.

A **lane** is one data-axis slot's share of a scan: chunk ``i`` of a
K-lane scan goes to lane ``i % K`` (``data/pipeline_scan.py``), and a
consumer keeps one partial accumulator per lane (a Gram, a BCD cross term,
a Chan triple) that it reduces across the lanes once per block or once at
the end (:func:`reduce_lane_partials`), never once per chunk. Each partial
that crosses to another slot is counted on the scan as a collective, so
the ``scan.pipeline`` span's ``collectives`` shows that the count grows
with the blocks and not with the chunks.

``KEYSTONE_SCAN_LANES`` sets the lane count, clamped to the size of the
data axis; without it a scan has a lane a data-axis slot of a chosen mesh
(set, or provisioned) and one lane otherwise, on one card or several: the
single-accumulator path. On one card with a mesh of several slots of
``cuda:0`` the lanes share the card: the partials and chunks of every
lane are on it, and a crossing is counted but copies nothing.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from .mesh import DATA_AXIS, Slot, default_mesh, mesh_or_none


def scan_lanes(mesh=None) -> int:
    """The lane count of a scan: ``KEYSTONE_SCAN_LANES`` clamped to the
    size of the data axis. Without the variable it is the data axis of a
    mesh that was chosen (passed here, set with ``set_default_mesh`` /
    ``use_mesh``, or provisioned virtual devices), and 1 for a mesh built
    only from the visible cards or with no mesh: lanes over several
    physical cards have had no run yet, so they start only when asked for."""
    from ..utils import env_int
    from .mesh import mesh_was_chosen

    m = mesh_or_none(mesh)
    n_data = 1 if m is None else int(m.shape[DATA_AXIS])
    default = n_data if mesh is not None or mesh_was_chosen() else 1
    return min(env_int("KEYSTONE_SCAN_LANES", default), n_data)


def lane_devices(lanes: Optional[int] = None, mesh=None) -> List[Slot]:
    """The slot of each lane: round robin over the data axis at model
    index 0 (lane state is data parallel)."""
    m = mesh if mesh is not None else default_mesh()
    devs = list(m.devices[:, 0].flat)
    k = lanes if lanes is not None else scan_lanes(mesh)
    return [devs[i % len(devs)] for i in range(k)]


def record_scan_collectives(scan: Any, n: int) -> None:
    """Count ``n`` crossings between slots (partial reductions, model
    broadcasts) on ``scan`` when it is a pipelined scan."""
    rec = getattr(scan, "record_collectives", None)
    if rec is not None and n:
        rec(n)


def tree_map(fn, tree: Any) -> Any:
    """``fn`` over the tensors of a tensor or (nested) tuple or list."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree) if tree is not None and hasattr(tree, "to") else tree


def to_slot(tree: Any, slot: Slot) -> Any:
    """``tree``'s tensors on ``slot``'s device (no copy when they are
    there)."""
    return tree_map(lambda t: t.to(slot.device), tree)


def gather_lane_partials(partials: Sequence[Any], scan: Any = None,
                         devices: Optional[Sequence[Slot]] = None) -> List[Any]:
    """The non-None partials (partial ``i`` is lane ``i``'s; tensors or
    tuples of them), in lane order, each moved to the first one's slot.
    ``devices`` are the lanes' slots (default :func:`lane_devices`). Each
    partial on another slot than the first is counted as a collective on
    ``scan``."""
    live = [(i, p) for i, p in enumerate(partials) if p is not None]
    if len(live) <= 1:
        return [p for _, p in live]
    slots = list(devices) if devices is not None else lane_devices(len(partials))
    lead = slots[live[0][0]]
    out, moved = [live[0][1]], 0
    for i, p in live[1:]:
        if slots[i] != lead:
            p = to_slot(p, lead)
            moved += 1
        out.append(p)
    record_scan_collectives(scan, moved)
    return out


def reduce_lane_partials(partials: Sequence[Any], scan: Any = None,
                         devices: Optional[Sequence[Slot]] = None):
    """The sum of the lanes' partials on the first one's slot, in lane
    order (so a given lane count reduces the same way on every run); None
    when every partial is None."""
    parts = gather_lane_partials(partials, scan, devices)
    if not parts:
        return None
    total = parts[0]
    for p in parts[1:]:
        total = _add(total, p)
    return total


def _add(a: Any, b: Any) -> Any:
    if a is None:
        return None
    if isinstance(a, (tuple, list)):
        return type(a)(_add(x, y) for x, y in zip(a, b))
    return a + b
