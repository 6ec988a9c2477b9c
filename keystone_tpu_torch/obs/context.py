"""Cross-process trace propagation: the context one request carries
(port of ``keystone_tpu/obs/context.py``).

The tracer (``obs/tracer.py``) keeps one span registry a process; a
:class:`TraceContext` lets one request keep its identity while it crosses
the process tier (router, wire, worker, replica). It is small (an id, the
hop that emitted it, a wall-clock send stamp), since it rides on every
request frame of a sampled request:

* ``trace_id``: unique per admitted request and namespaced by the
  originating process's pid (``"<pid-hex>-<seq-hex>"``), so two routers on
  one machine never mint the same id and a stitched export can merge the
  span sets of many processes;
* ``hop``: the name of the span that emitted the context;
* ``sent_unix``: ``time.time()`` at send. Monotonic clocks are
  process-local; the unix clock is shared by the processes of a host, so a
  receiver reckons the transport time as ``time.time() - sent_unix``.

In-process, :meth:`ServingFleet.submit(trace=...)
<keystone_tpu_torch.serving.fleet.ServingFleet.submit>` takes a context
and the replica records the request's ``serve.queue`` span under its id.

Sampling: ``KEYSTONE_TRACE_SAMPLE`` is the per-request sampling rate
(default 1.0, every request of a traced run). At rate r the cost a request
is r times a few span records, and one modulo test for an unsampled one.
The flight recorder (``obs/flight.py``) ignores sampling.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional


def sample_rate() -> float:
    """``KEYSTONE_TRACE_SAMPLE`` clamped to [0, 1] (default 1.0)."""
    from ..utils import env_float

    return min(1.0, env_float("KEYSTONE_TRACE_SAMPLE", 1.0, minimum=0.0))


class Sampler:
    """Deterministic every-Nth sampling at ``rate``: request k is sampled
    iff ``k % round(1/rate) == 0``, so a traced and an untraced run sample
    the same positions and a test of rate 0.25 sees exactly 1 in 4. Not
    thread-safe: callers draw under their admission lock."""

    def __init__(self, rate: Optional[float] = None):
        self.rate = sample_rate() if rate is None else float(rate)
        self._every = 0 if self.rate <= 0.0 else max(1, int(round(1.0 / self.rate)))
        self._seq = 0

    def admit(self) -> bool:
        """One request's verdict (and count)."""
        if not self._every:
            return False
        k = self._seq
        self._seq += 1
        return k % self._every == 0


@dataclass
class TraceContext:
    """One request's cross-process identity (see the module docstring)."""

    trace_id: str
    hop: Optional[str] = None
    sent_unix: Optional[float] = None

    def to_wire(self) -> dict:
        """The wire form, stamped with the send time now: serializing is
        part of the hop, so the stamp is taken as late as it can be."""
        return {"id": self.trace_id, "hop": self.hop, "sent_unix": time.time()}

    @staticmethod
    def from_wire(enc: Optional[dict]) -> Optional["TraceContext"]:
        if not enc or not enc.get("id"):
            return None
        return TraceContext(trace_id=str(enc["id"]), hop=enc.get("hop"),
                            sent_unix=enc.get("sent_unix"))

    def transport_seconds(self) -> Optional[float]:
        """Transport and wake-up since the sender stamped this context,
        never negative (the unix clock can step back)."""
        if self.sent_unix is None:
            return None
        return max(0.0, time.time() - float(self.sent_unix))


def new_trace_id(seq: int) -> str:
    """A process-namespaced trace id (pid and sequence, in hex)."""
    return f"{os.getpid():x}-{seq:x}"
