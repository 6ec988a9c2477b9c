"""The device mesh, the scan lanes, the virtual devices and replica
placement (port of ``keystone_tpu/parallel/``). A mesh holds slots of
physical devices (``mesh.Slot``): on one card or on the CPU, N virtual
devices are N slots of that one device."""

from .lanes import (
    gather_lane_partials,
    lane_devices,
    record_scan_collectives,
    reduce_lane_partials,
    scan_lanes,
)
from .placement import data_axis_devices, replica_devices, worker_device_indices
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    NamedSharding,
    Slot,
    batch_sharding,
    column_sharding,
    default_mesh,
    make_mesh,
    mesh_n_data,
    mesh_size,
    pad_to_multiple,
    replicate,
    replicated_sharding,
    set_default_mesh,
    shard_batch,
    shard_classes,
    sharding_of,
    use_mesh,
)
from .virtual import (
    clear_virtual_devices,
    provision_from_env,
    provision_virtual_devices,
    virtual_slots,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "NamedSharding",
    "Slot",
    "batch_sharding",
    "clear_virtual_devices",
    "column_sharding",
    "data_axis_devices",
    "default_mesh",
    "gather_lane_partials",
    "lane_devices",
    "make_mesh",
    "mesh_n_data",
    "mesh_size",
    "pad_to_multiple",
    "provision_from_env",
    "provision_virtual_devices",
    "record_scan_collectives",
    "reduce_lane_partials",
    "replica_devices",
    "replicate",
    "replicated_sharding",
    "scan_lanes",
    "set_default_mesh",
    "shard_batch",
    "shard_classes",
    "sharding_of",
    "use_mesh",
    "virtual_slots",
    "worker_device_indices",
]
