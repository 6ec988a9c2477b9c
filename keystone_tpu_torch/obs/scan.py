"""Scan spans: the tracer's record of a pipelined out-of-core scan (port of
``keystone_tpu/obs/scan.py``).

One ``scan.pipeline`` span per scan of ``data/pipeline_scan.py``, from the
first chunk asked for to exhaustion or an early close, with the scan's
counters (``ScanStats``) as attrs: host production seconds in the
producer thread, producer-stall (queue full: the consumer is the slower
side) and consumer-stall (queue empty: the producer is) seconds, staged
bytes, the queue's peak occupancy and the chunk count. A scan that
overlaps well reads ``seconds`` near max(producer, consumer) work, not
their sum, and the stall counters say which side bounded it.

A laned scan (``lanes > 1``, ``parallel/lanes.py``) also carries its
lanes: ``lanes``, each lane's chunks and staged bytes (``lane_chunks``,
``lane_bytes``; their skew, max over mean staged bytes, is
``lane_imbalance``), each lane's slot (``devices``) and ``collectives``,
the crossings between slots that its consumer counted (stamped onto the
span after it was recorded when the reduction comes at the end). One
``scan.pipeline.lane`` child span a lane nests under it with that lane's
slot, chunks and bytes, so a straggling lane shows in the trace tree. The
schema is the JAX package's.

A scan's end is an allocation peak (staged chunks and the accumulators
alive), so the device-memory watermark (``resource.sample_memory()``) is
sampled there, traced or not.
"""

from __future__ import annotations

from typing import Optional

from .span import Span
from .tracer import current

#: the span name every pipelined scan records
SCAN_SPAN = "scan.pipeline"
#: the child span of each lane of a laned scan
SCAN_LANE_SPAN = "scan.pipeline.lane"


def record_scan_span(stats) -> Optional[Span]:
    """Record one finished scan's counters as a complete span; returns it,
    or None when tracing is off. Samples the memory watermark either way."""
    from . import resource

    resource.sample_memory()
    tracer = current()
    if tracer is None:
        return None
    attrs = {
        "label": stats.label,
        "chunks": stats.chunks,
        "depth": stats.depth,
        "producer_seconds": round(stats.producer_seconds, 6),
        "producer_stall_seconds": round(stats.producer_stall_seconds, 6),
        "consumer_stall_seconds": round(stats.consumer_stall_seconds, 6),
        "staged_bytes": stats.staged_bytes,
        "occupancy_max": stats.occupancy_max,
    }
    if stats.retries:
        # stamped only when nonzero, so fault-free traces keep their schema
        attrs["retries"] = stats.retries
    if stats.shards > 1:
        attrs["shards"] = stats.shards
        attrs["shard_chunks"] = list(stats.shard_chunks)
    if stats.lanes > 1:
        attrs.update(lanes=stats.lanes, collectives=stats.collectives,
                     lane_chunks=list(stats.lane_chunks), lane_bytes=list(stats.lane_bytes),
                     devices=list(stats.lane_devices))
        total = sum(stats.lane_bytes)
        if total > 0:
            attrs["lane_imbalance"] = round(max(stats.lane_bytes) * stats.lanes / total, 3)
    sp = Span(name=SCAN_SPAN, start=stats.start, end=stats.end, op_type="ScanPipeline",
              attrs=attrs)
    tracer.record_complete(sp)
    for lane in range(stats.lanes if stats.lanes > 1 else 0):
        tracer.record_complete(Span(
            name=SCAN_LANE_SPAN, start=stats.start, end=stats.end, parent_id=sp.span_id,
            depth=sp.depth + 1, op_type="ScanPipeline",
            attrs={"label": stats.label, "lane": lane, "device": stats.lane_devices[lane],
                   "chunks": stats.lane_chunks[lane], "staged_bytes": stats.lane_bytes[lane]}))
    return sp
