"""Device placement (port of ``keystone_tpu/parallel/``, its
``placement`` module): which device each serving replica and each cluster
worker serves on. The mesh, the lanes and the virtual devices come with
ROADMAP Queue 1 item 14b."""

from .placement import data_axis_devices, replica_devices, worker_device_indices

__all__ = ["data_axis_devices", "replica_devices", "worker_device_indices"]
