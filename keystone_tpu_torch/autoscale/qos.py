"""QoS primitives: the priority vocabulary and the weighted-fair queue
(port of ``keystone_tpu/autoscale/qos.py``).

Two axes, kept apart:

* **Priority** (``high`` / ``normal`` / ``low``) is the shedding axis.
  Admission prices a request's wait against its deadline, and priority
  decides how much of the queue ahead it pays for: the fleet scheduler
  counts only the depth at the same or a better priority (exact, since it
  owns the queues); the cluster front door, which comes with ``cluster/``,
  scales its aggregate estimate by :data:`SHED_BIAS`. At equal deadline
  slack a low request always sheds before a high one.
* **Tenant** is the fairness axis. Each per-replica queue is a
  :class:`WeightedFairQueue`: deficit round robin across tenants, so the
  scheduler serves tenants in proportion to their weights, not first come
  first served. Within one tenant dispatch goes by priority; across
  tenants priority does not jump the fairness schedule, so a tenant cannot
  buy the whole fleet by marking everything ``high``.

The queue speaks a deque's verbs (``append``, ``appendleft``,
``popleft``, ``pop``), which the scheduler's admission, gather, steal and
requeue drive, and every request carries its own ``priority`` and
``tenant``, so a clone, a steal or a requeue keeps both.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterator, List, Optional

#: the priority vocabulary, best first (also the dispatch order within one
#: tenant's lanes)
PRIORITIES = ("high", "normal", "low")

#: priority -> dispatch rank (0 serves first and sheds last)
PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}

DEFAULT_PRIORITY = "normal"
DEFAULT_TENANT = "default"

#: the cluster front door's admission bias on its aggregate wait estimate,
#: by priority: monotone in rank, so its shed order is deterministic too
SHED_BIAS = {"high": 0.5, "normal": 1.0, "low": 1.5}


def normalize_priority(priority: Optional[str]) -> str:
    """The canonical priority (``None`` is ``normal``); a value outside the
    vocabulary raises ``ValueError``: a mistyped priority fails the submit
    rather than serving as normal."""
    if priority is None:
        return DEFAULT_PRIORITY
    p = str(priority).lower()
    if p not in PRIORITY_RANK:
        raise ValueError(f"unknown priority {priority!r} (expected one of {PRIORITIES})")
    return p


def request_rank(req) -> int:
    """The dispatch rank of anything with an optional ``priority``."""
    return PRIORITY_RANK.get(getattr(req, "priority", DEFAULT_PRIORITY),
                             PRIORITY_RANK["normal"])


def request_tenant(req) -> str:
    return getattr(req, "tenant", DEFAULT_TENANT) or DEFAULT_TENANT


class WeightedFairQueue:
    """Deficit round robin over per-tenant priority lanes.

    Each tenant owns one deque a priority rank. ``popleft`` runs the round:
    the tenant at its head is credited one quantum a visit (its weight over
    the largest weight in the round, so the heaviest tenant's quantum is
    one request); a tenant whose deficit reaches 1.0 serves the head of its
    best non-empty lane and pays 1.0, otherwise it goes to the back and
    keeps its deficit. Over any window the served ratio tends to the weight
    ratio, in a fixed order. A tenant that empties leaves the round and
    forfeits its deficit: fairness shares the present backlog and banks no
    credit for traffic a tenant never sent.

    ``append`` / ``appendleft`` place a request in its own (tenant, rank)
    lane; ``pop`` (the stealing verb) takes the newest request of the
    lowest populated rank from the tenant deepest in it, so the victim
    keeps its oldest work and its best class; iteration yields everything.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0):
        self._weights = {str(k): float(v) for k, v in (weights or {}).items()}
        for t, w in self._weights.items():
            if w <= 0:
                raise ValueError(f"tenant {t!r} weight must be > 0, got {w}")
        self._default_weight = float(default_weight)
        #: tenant -> one deque a priority rank
        self._lanes: Dict[str, List[deque]] = {}
        self._round: deque = deque()  # the tenants holding turns
        self._in_round: set = set()
        self._deficit: Dict[str, float] = {}
        self._charged: Dict[str, bool] = {}
        self._len = 0

    # -- weights ---------------------------------------------------------

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, self._default_weight)

    def _quantum(self, tenant: str) -> float:
        return self.weight(tenant) / max(self.weight(t) for t in self._round)

    # -- writes ------------------------------------------------------------

    def _enter(self, req) -> List[deque]:
        tenant = request_tenant(req)
        lanes = self._lanes.get(tenant)
        if lanes is None:
            lanes = self._lanes[tenant] = [deque() for _ in PRIORITIES]
        if tenant not in self._in_round:
            self._in_round.add(tenant)
            self._round.append(tenant)
            self._deficit.setdefault(tenant, 0.0)
            self._charged.setdefault(tenant, False)
        return lanes

    def append(self, req) -> None:
        self._enter(req)[request_rank(req)].append(req)
        self._len += 1

    def appendleft(self, req) -> None:
        """The front of the request's own (tenant, rank) lane: the requeue
        verb. Rerouted work is the oldest in the system and does not queue
        again, but it jumps only its own line."""
        self._enter(req)[request_rank(req)].appendleft(req)
        self._len += 1

    def extend(self, reqs) -> None:
        for r in reqs:
            self.append(r)

    # -- reads and removals ------------------------------------------------

    def _retire(self, tenant: str) -> None:
        """An emptied tenant leaves the round; its deficit is forfeited."""
        if self._round and self._round[0] == tenant:
            self._round.popleft()
        elif tenant in self._round:
            self._round.remove(tenant)
        self._in_round.discard(tenant)
        self._deficit[tenant] = 0.0
        self._charged[tenant] = False

    @staticmethod
    def _pop_ranked(lanes: List[deque]):
        for lane in lanes:
            if lane:
                return lane.popleft()
        raise IndexError("pop from empty tenant lanes")

    def popleft(self):
        """The next request the fairness schedule owes."""
        if not self._len:
            raise IndexError("pop from an empty WeightedFairQueue")
        spins = 0
        while True:
            tenant = self._round[0]
            lanes = self._lanes[tenant]
            if not any(lanes):
                self._retire(tenant)
                continue
            if len(self._round) == 1:
                # the only tenant: serve it directly, its deficit parked
                self._len -= 1
                return self._pop_ranked(lanes)
            if not self._charged[tenant]:
                self._deficit[tenant] += self._quantum(tenant)
                self._charged[tenant] = True
            if self._deficit[tenant] >= 1.0 or spins > 64 * len(self._round):
                # the spin bound caps extreme weight ratios; the order is
                # plain deficit round robin for any spread below ~1:64
                self._deficit[tenant] = max(0.0, self._deficit[tenant] - 1.0)
                self._charged[tenant] = False
                self._round.rotate(-1)
                self._len -= 1
                return self._pop_ranked(lanes)
            # not enough deficit: keep it and yield the turn
            self._charged[tenant] = False
            self._round.rotate(-1)
            spins += 1

    def pop(self):
        """The stealing verb: the newest request of the lowest populated
        rank, from the tenant deepest in that rank."""
        if not self._len:
            raise IndexError("pop from an empty WeightedFairQueue")
        for rank in range(len(PRIORITIES) - 1, -1, -1):
            best = None
            for tenant, lanes in self._lanes.items():
                if lanes[rank] and (best is None
                                    or len(lanes[rank]) > len(self._lanes[best][rank])):
                    best = tenant
            if best is not None:
                self._len -= 1
                return self._lanes[best][rank].pop()
        raise IndexError("pop from an empty WeightedFairQueue")  # unreachable

    def clear(self) -> None:
        self._lanes.clear()
        self._round.clear()
        self._in_round.clear()
        self._deficit.clear()
        self._charged.clear()
        self._len = 0

    def __iter__(self) -> Iterator:
        for lanes in self._lanes.values():
            for lane in lanes:
                yield from lane

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __getitem__(self, index: int):
        """The request at ``index`` in iteration order (tenants in order of
        arrival, then rank, then arrival): for tests and introspection."""
        n = self._len
        if index < 0:
            index += n
        if not 0 <= index < n:
            raise IndexError(index)
        for i, req in enumerate(self):
            if i == index:
                return req
        raise IndexError(index)  # unreachable: _len guards above

    # -- QoS introspection ---------------------------------------------------

    def rank_lens(self) -> List[int]:
        """Queued requests a priority rank (index = rank): what the
        scheduler's admission pricing sums."""
        out = [0] * len(PRIORITIES)
        for lanes in self._lanes.values():
            for rank, lane in enumerate(lanes):
                out[rank] += len(lane)
        return out

    def tenant_depths(self) -> Dict[str, int]:
        return {t: sum(len(lane) for lane in lanes)
                for t, lanes in self._lanes.items() if any(lanes)}
