"""The fleet's admission surface and continuous-batching dispatcher (port
of ``keystone_tpu/serving/scheduler.py``).

One :class:`FleetScheduler` sits between any number of submitter threads
and N :class:`~keystone_tpu_torch.serving.replica.Replica` workers. It
replaces the single engine's gather-then-dispatch loop with **continuous
batching**: a replica that frees up starts forming its next micro-batch at
once from what is queued, and requests that arrive while it forms join it.

Three disciplines, under one lock (its hold times are microseconds):

* **Deadline-aware admission.** A request whose deadline cannot be met
  (``now + estimated wait > deadline``, the estimate being the learned
  EWMA of a batch's service time scaled by the queue ahead of it) is
  refused with a typed :class:`Shed` before it takes a queue slot or card
  time. The replica still expires at batch time what admission could not
  predict. With no service evidence yet nothing is shed.
* **Occupancy-maximizing dispatch.** A free replica pops its queue and
  gathers until the forming batch fills its bucket exactly, the
  ``max_wait`` window closes, or the tightest deadline in the batch says a
  longer wait would expire it.
* **Work stealing.** Admission places each request on the shallowest live
  queue; a replica whose queue is empty steals the newest half of the
  deepest peer's queue, so one stalled replica cannot idle the rest.

QoS (``autoscale/qos.py``) rides all three: admission prices a request's
wait against the depth at its priority or better only (exact, since the
scheduler owns its queues), so at equal slack low sheds strictly before
high; the per-replica queues are :class:`WeightedFairQueue` s, which serve
tenants in proportion to their weights; and requeues, steals and hops keep
both identities because they live on the request.

The replica's service seconds end after its batch's copy out, which waits
for the card, so the estimate learns the device's time, not a launch's.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from ..autoscale.qos import (
    PRIORITIES,
    PRIORITY_RANK,
    WeightedFairQueue,
    request_rank,
    request_tenant,
)
from ..obs.tracer import current as _trace_current
from .batching import BucketPolicy
from .errors import EngineStopped, QueueFull, Shed
from .metrics import MetricsRegistry
from .replica import STOP, _Request, settle_future

logger = logging.getLogger(__name__)

#: EWMA smoothing of the learned batch service time: heavy enough to follow
#: a swap to a slower model within a few batches, light enough that one
#: straggler batch does not triple the shed threshold
_SERVICE_ALPHA = 0.3


def _chain_futures(clone, orig) -> None:
    """Forward a requeued clone's outcome to the original future, which may
    already be running (it was taken into the batch the failed replica
    never finished), so it cannot enter a queue again itself."""

    def _copy(done):
        if orig.done():
            return
        try:
            if done.cancelled():
                orig.cancel()
                return
            exc = done.exception()
            if exc is not None:
                orig.set_exception(exc)
            else:
                orig.set_result(done.result())
        except Exception:  # lost a race with another settler: the other
            pass           # answer stands

    clone.add_done_callback(_copy)


class ServiceEstimate:
    """The learned batch-service-time EWMA and its admission pricing: the
    one deadline-shedding discipline, shared by the fleet scheduler and, in
    the JAX package, the cluster router's front door. Not thread-safe;
    callers fold observations under their admission lock."""

    #: the share of one learned batch time a coalescer may hold a partial
    #: frame open: small enough to vanish in the service time it saves
    COALESCE_FRACTION = 0.25

    def __init__(self, alpha: float = _SERVICE_ALPHA):
        self._alpha = alpha
        self._ewma: Optional[float] = None

    @property
    def estimate(self) -> Optional[float]:
        """Learned seconds a micro-batch, None before any evidence."""
        return self._ewma

    def observe(self, seconds: float) -> None:
        prev = self._ewma
        self._ewma = seconds if prev is None else prev + self._alpha * (seconds - prev)

    def wait(self, depth: int, capacity: int) -> float:
        """The completion estimate of a request admitted now: its own
        batch's service time plus the whole batches queued ahead of it
        (``depth`` requests over ``capacity`` rows of concurrent batch
        capacity). Zero before any evidence: a cold admission surface does
        not shed traffic it cannot price."""
        s = self._ewma
        if s is None:
            return 0.0
        return s * (1 + depth // max(int(capacity), 1))

    def coalesce_window(self, now: float, tightest_deadline: Optional[float] = None,
                        cap: float = 0.002) -> float:
        """The longest a front-door coalescer may hold a started frame open
        for more members: at most :attr:`COALESCE_FRACTION` of a learned
        batch time, at most ``cap``, and no later than the tightest
        member's deadline less one batch time. Zero before any evidence."""
        s = self._ewma
        if s is None:
            return 0.0
        w = min(float(cap), self.COALESCE_FRACTION * s)
        if tightest_deadline is not None:
            w = min(w, tightest_deadline - now - s)
        return max(0.0, w)


class FleetScheduler:
    """One admission queue and a run queue a replica, for N replicas."""

    #: a request rerouted off this many failed replicas stops bouncing and
    #: is answered with the failure: the bound that keeps a request without
    #: a deadline from cycling forever across a recurring fault
    MAX_REQUEUE_HOPS = 3

    def __init__(self, n_replicas: int, policy: BucketPolicy, metrics: MetricsRegistry, *,
                 max_queue: int = 1024, max_wait_ms: float = 2.0, steal: bool = True,
                 tenant_weights: Optional[Dict[str, float]] = None):
        if n_replicas < 1:
            raise ValueError(f"need at least one replica, got {n_replicas}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._n = n_replicas
        self._policy = policy
        self._metrics = metrics
        self._max_queue = max_queue
        self._max_wait = max_wait_ms / 1000.0
        self._steal = steal
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        #: configured tenant -> weight (a tenant not listed weighs 1.0)
        self._tenant_weights = dict(tenant_weights or {})
        #: the per-replica run queues: weighted-fair across tenants,
        #: priority-ordered within one
        self._queues: List[WeightedFairQueue] = [
            WeightedFairQueue(self._tenant_weights) for _ in range(n_replicas)]
        #: replica liveness, kept by the fleet's supervisor: a replica down
        #: for good receives no admission
        self._active: List[bool] = [True] * n_replicas
        self._depth = 0  # queued, over every replica queue
        self._in_flight = 0  # batches handed to replicas and not done
        self._closed = False  # no further admission
        self._stop = False  # workers should exit
        self._service = ServiceEstimate()

    # -- introspection ---------------------------------------------------

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    @property
    def service_estimate(self) -> Optional[float]:
        """Learned seconds a micro-batch (EWMA), None before evidence."""
        return self._service.estimate

    def queue_depths(self) -> List[int]:
        with self._lock:
            return [len(q) for q in self._queues]

    def qos_snapshot(self) -> Dict[str, object]:
        """The queues' QoS view now: each tenant's queued depth and
        weight, and the queued count of each priority."""
        with self._lock:
            tenants: Dict[str, Dict[str, float]] = {}
            by_rank = [0] * len(PRIORITIES)
            for q in self._queues:
                for t, n in q.tenant_depths().items():
                    row = tenants.setdefault(t, {"queued": 0, "weight": q.weight(t)})
                    row["queued"] += n
                for rank, n in enumerate(q.rank_lens()):
                    by_rank[rank] += n
            for t, w in self._tenant_weights.items():
                tenants.setdefault(t, {"queued": 0, "weight": w})
            return {"tenants": tenants,
                    "queued_by_priority": {p: by_rank[PRIORITY_RANK[p]] for p in PRIORITIES}}

    # -- service-time learning -------------------------------------------

    def observe_service(self, seconds: float) -> None:
        """Fold one batch's measured seconds into the estimate (also the
        seam a test uses to seed a known estimate)."""
        self._service.observe(seconds)

    def estimated_wait(self, rank: Optional[int] = None) -> float:
        """The completion estimate of a request admitted now
        (:meth:`ServiceEstimate.wait`) over the fleet's capacity. ``rank``
        prices only the depth at that priority or better, the depth that
        outranks the request; None prices all of it."""
        if rank is None:
            depth = self._depth
        else:
            depth = sum(sum(q.rank_lens()[:rank + 1]) for q in self._queues)
        return self._service.wait(depth, self._n * self._policy.max_size)

    def _rank_waits(self) -> List[float]:
        """:meth:`estimated_wait` of each rank, once for a requeue sweep
        (lock held)."""
        return [self.estimated_wait(rank) for rank in range(len(PRIORITIES))]

    # -- admission -------------------------------------------------------

    def admit(self, req: _Request) -> None:
        """Place one request, or raise typed: :class:`EngineStopped` after
        close, :class:`QueueFull` at capacity, :class:`Shed` when its
        deadline is unmeetable. The closed test and the enqueue are one
        step: a request lands before the close (and the drain answers it)
        or gets the typed error, never stranded."""
        with self._cond:
            if self._closed:
                raise EngineStopped("fleet is draining / shut down")
            if self._depth >= self._max_queue:
                self._metrics.inc("rejected")
                raise QueueFull(f"admission queue at capacity ({self._max_queue})")
            if req.deadline is not None:
                est = self.estimated_wait(request_rank(req))
                if time.monotonic() + est > req.deadline:
                    self._metrics.inc("shed")
                    self._metrics.inc(f"shed.{req.priority}")
                    raise Shed(
                        f"deadline unmeetable at admission: estimated wait {est:.4f}s "
                        f"(at priority {req.priority!r}) exceeds the request's "
                        f"{max(req.deadline - time.monotonic(), 0):.4f}s budget")
            # the shallowest live queue; uneven drain rates are stealing's job
            live = [i for i in range(self._n) if self._active[i]]
            if not live:
                raise EngineStopped("no live replicas (every worker is down and the restart "
                                    "budget is exhausted)")
            target = min(live, key=lambda i: len(self._queues[i]))
            self._queues[target].append(req)
            self._depth += 1
            # counted under the lock, so no snapshot sees a request completed
            # before it was submitted
            self._metrics.inc("submitted")
            self._cond.notify_all()

    # -- dispatch (the replica's batch source) ---------------------------

    def next_batch(self, replica):
        """The next micro-batch for ``replica``: from its own queue
        (stealing when it is empty), gathering arrivals until the bucket is
        exactly full, ``max_wait`` closes, or the tightest deadline forces
        dispatch."""
        t0 = time.monotonic()
        with self._cond:
            while True:
                if self._stop:
                    return STOP
                stolen = self._maybe_steal(replica.index)
                if self._queues[replica.index]:
                    break
                # idle (drained and closed included): poll so that the final
                # STOP is seen promptly
                self._cond.wait(timeout=0.05)
            batch = self._gather(replica.index)
            self._in_flight += 1
            depth = self._depth
        tracer = _trace_current()
        if tracer is not None:
            bucket = self._policy.bucket_for(len(batch))
            tracer.instant("serve.dispatch", op_type="FleetScheduler", replica=replica.index,
                           items=len(batch), bucket=bucket,
                           occupancy=round(len(batch) / bucket, 3), stolen=stolen,
                           waited_ms=round((time.monotonic() - t0) * 1e3, 3),
                           queue_depth=depth)
        return batch

    def batch_done(self, batch, replica) -> None:
        exec_s = replica.last_exec_seconds
        with self._cond:
            self._in_flight -= 1
            if exec_s is not None:
                self.observe_service(exec_s)
            self._cond.notify_all()

    def _gather(self, index: int) -> List[_Request]:
        """Pop the forming batch from queue ``index`` (lock held). It waits
        for arrivals only while the batch does not fill its bucket exactly,
        the max-wait window is open, and every gathered deadline still
        affords the wait."""
        own = self._queues[index]
        batch = [own.popleft()]
        self._depth -= 1
        gather_until = time.monotonic() + self._max_wait
        while len(batch) < self._policy.max_size:
            while own and len(batch) < self._policy.max_size:
                batch.append(own.popleft())
                self._depth -= 1
            if len(batch) == self._policy.bucket_for(len(batch)):
                break  # exactly full: occupancy 1.0, nothing to wait for
            now = time.monotonic()
            wait_budget = gather_until - now
            # the batch takes the learned service time once dispatched; a
            # wait may use only the slack beyond it
            exec_s = self._service.estimate or 0.0
            for r in batch:
                if r.deadline is not None:
                    wait_budget = min(wait_budget, r.deadline - now - exec_s)
            if wait_budget <= 0:
                break
            if not self._cond.wait(timeout=wait_budget) and not own:
                break  # the window closed with no arrival: dispatch
        served: Dict[str, int] = {}
        for r in batch:
            t = request_tenant(r)
            served[t] = served.get(t, 0) + 1
        for t, n in served.items():
            # per-tenant service counters, summable across processes
            self._metrics.inc(f"tenant.served.{t}", n)
        return batch

    def _maybe_steal(self, index: int) -> int:
        """With queue ``index`` empty, move the newest half of the deepest
        peer queue over (lock held). Returns the requests moved."""
        if not self._steal or self._queues[index]:
            return 0
        victim = max((i for i in range(self._n) if i != index),
                     key=lambda i: len(self._queues[i]), default=None)
        if victim is None or not self._queues[victim]:
            return 0
        vq = self._queues[victim]
        take = len(vq) // 2 or 1
        # from the back: the victim keeps its oldest (tightest) requests in
        # order, the thief takes the newest
        moved = [vq.pop() for _ in range(take)]
        self._queues[index].extend(reversed(moved))
        self._metrics.inc("steals", take)
        return take

    # -- replica supervision -----------------------------------------------

    def set_active(self, index: int, active: bool) -> None:
        """Mark one replica live or down for admission (the fleet's
        supervisor flips it around deaths and restarts)."""
        with self._cond:
            self._active[index] = bool(active)
            self._cond.notify_all()

    def any_active(self) -> bool:
        with self._cond:
            return any(self._active)

    def _shed_requeued(self, req: _Request, est: float, now: float) -> None:
        self._metrics.inc("shed")
        self._metrics.inc(f"shed.{getattr(req, 'priority', 'normal')}")
        settle_future(req.future, Shed(
            f"deadline unmeetable after replica failure: estimated wait {est:.4f}s exceeds "
            f"the request's remaining {max(req.deadline - now, 0):.4f}s budget"))

    def requeue_replica(self, index: int, keep_if_no_peer: bool = False) -> int:
        """Move a down replica's queued requests to live peers, deadlines
        intact; one the learned estimate says can no longer make its
        deadline is answered with a typed :class:`Shed` here. With no live
        peer, ``keep_if_no_peer`` leaves the queue in place (the replica is
        about to restart), else the requests fail typed. Returns the count
        moved."""
        with self._cond:
            q = self._queues[index]
            if not q:
                return 0
            reqs = list(q)
            q.clear()
            now = time.monotonic()
            ests = self._rank_waits()
            peers = [i for i in range(self._n) if self._active[i] and i != index]
            moved = 0
            for req in reqs:
                if req.future.done():
                    self._depth -= 1
                    continue
                est = ests[request_rank(req)]
                if req.deadline is not None and now + est > req.deadline:
                    self._depth -= 1
                    self._shed_requeued(req, est, now)
                    continue
                if peers:
                    target = min(peers, key=lambda i: len(self._queues[i]))
                    self._queues[target].append(req)
                    moved += 1
                elif keep_if_no_peer:
                    q.append(req)
                else:
                    self._depth -= 1
                    settle_future(req.future,
                                  EngineStopped("no live replicas to take over this request"))
            if moved:
                self._metrics.inc("requeues", moved)
            self._cond.notify_all()
        return moved

    def requeue_batch(self, requests, replica, cause=None) -> int:
        """Admit a failed replica's in-flight requests again. Their futures
        may already be running, so each enters as a fresh clone whose
        outcome chains back to the original; deadlines and enqueue times
        carry over (a reroute never extends a deadline). An unmeetable
        deadline gets the typed :class:`Shed`; a request already rerouted
        :data:`MAX_REQUEUE_HOPS` times is answered with ``cause`` instead of
        bouncing on; the rest land at the front of the shallowest live peer
        queue, as the oldest work in the system. Returns the count
        requeued."""
        index = getattr(replica, "index", None)
        fail_exc = (cause if isinstance(cause, Exception)
                    else EngineStopped("request lost its replica repeatedly"))
        with self._cond:
            now = time.monotonic()
            ests = self._rank_waits()
            peers = [i for i in range(self._n) if self._active[i] and i != index]
            moved = 0
            # appendleft reverses, so walk the batch back to front to keep
            # its order at the head of the queue
            for req in reversed(list(requests)):
                if req.future.done():
                    continue
                est = ests[request_rank(req)]
                if req.deadline is not None and now + est > req.deadline:
                    self._shed_requeued(req, est, now)
                    continue
                if req.hops >= self.MAX_REQUEUE_HOPS:
                    settle_future(req.future, fail_exc)
                    continue
                if peers:
                    target = min(peers, key=lambda i: len(self._queues[i]))
                elif index is not None and self._active[index]:
                    target = index  # restarting in place: retry here
                else:
                    settle_future(req.future,
                                  EngineStopped("no live replicas to take over this request"))
                    continue
                clone = _Request(datum=req.datum, deadline=req.deadline, enqueued=req.enqueued,
                                 hops=req.hops + 1, trace=req.trace, priority=req.priority,
                                 tenant=req.tenant)
                _chain_futures(clone.future, req.future)
                self._queues[target].appendleft(clone)
                self._depth += 1
                moved += 1
            if moved:
                self._metrics.inc("requeues", moved)
            self._cond.notify_all()
        return moved

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        """Stop admission (a submit now raises EngineStopped); queued and
        in-flight work keeps draining."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued request is dispatched and every
        in-flight batch has completed: True when idle, False on timeout."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._cond:
            while self._depth > 0 or self._in_flight > 0:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining if remaining else 0.1)
            return True

    def stop(self) -> None:
        """Every worker's next ``next_batch`` returns STOP."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()

    def fail_remaining(self, reason: str = "fleet is shut down",
                       error: Optional[BaseException] = None) -> int:
        """Answer everything still queued with :class:`EngineStopped`
        (``reason``), or with ``error`` when given (the card's fault that
        stopped the fleet). Returns the requests failed."""
        with self._cond:
            remaining: List[_Request] = []
            for q in self._queues:
                remaining.extend(q)
                q.clear()
            self._depth = 0
            self._cond.notify_all()
        for r in remaining:
            settle_future(r.future, error if error is not None else EngineStopped(reason))
        return len(remaining)
