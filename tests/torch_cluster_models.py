"""Models the port's cluster tests ship to worker processes. Importable
in a worker without JAX: it imports only the port."""

import os

import torch

from keystone_tpu_torch.workflow.transformer import Transformer


class FaultOnTrigger(Transformer):
    """``2 · X``, until the file ``trigger`` exists: then one batch removes
    it and raises the card's out-of-memory error, a device fault
    (``ops.is_device_fault``). One-shot, so a respawned worker serves."""

    row_local = True

    def __init__(self, trigger: str):
        self.trigger = trigger

    @property
    def label(self) -> str:
        return "fault_on_trigger"

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        if os.path.exists(self.trigger):
            os.remove(self.trigger)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return X * 2.0


def faulting_model(trigger: str):
    return FaultOnTrigger(trigger).to_pipeline().fit()
